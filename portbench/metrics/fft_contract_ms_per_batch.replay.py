"""``fft_contract_ms_per_batch.replay``: the time of the span
``power.fft_contract`` (the host's time to enqueue the Bartlett
program's contraction with the steering tensor, the squares and the sum
over bins) per ``stage.batch`` of the traced window, ms."""

from portbench import spans


def read(run):
    return spans.per_batch_ms(("power.fft_contract",))
