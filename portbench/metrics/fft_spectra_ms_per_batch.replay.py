"""``fft_spectra_ms_per_batch.replay``: the time of the span
``power.fft_spectra`` (the host's time to enqueue the Bartlett program's
channel gather, rfft and band select) per ``stage.batch`` of the traced
window, ms."""

from portbench import spans


def read(run):
    return spans.per_batch_ms(("power.fft_spectra",))
