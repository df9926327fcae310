"""``mvdr_d0_device_ms_per_batch.stream``: the device time of the
kernels and memsets launched while ``power.mvdr_d0`` (the full quadratic
form, every 2nd batch at K=16) was the innermost span, per
``stage.batch`` of the traced session, ms."""

from portbench import span_device


def read(run):
    return span_device.per_batch_ms(run, ("power.mvdr_d0",))
