"""``power_kernel_device_ms_per_batch.replay``: the device time of the
kernels and memsets launched while ``power.kernel`` (K1 or K2) or
``power.fft_contract`` (the Bartlett kernel) was the innermost span, per
``stage.batch`` of the traced session, ms."""

from portbench import span_device


def read(run):
    return span_device.per_batch_ms(run, ("power.kernel",
                                          "power.fft_contract"))
