"""``power_prep_device_ms_per_batch.replay``: the device time of the
kernels and memsets launched while ``power.pad`` (the upcast and the pad
back to the full mic axis), ``power.inputs`` (the kernel's inputs: the
gather, cast, rfft and spectra, or the rows' padding) or
``power.fft_spectra`` (the FFT route's rfft) was the innermost span, per
``stage.batch`` of the traced session, ms."""

from portbench import span_device


def read(run):
    return span_device.per_batch_ms(run, ("power.pad", "power.inputs",
                                          "power.fft_spectra"))
