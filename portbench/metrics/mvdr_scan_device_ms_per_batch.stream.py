"""``mvdr_scan_device_ms_per_batch.stream``: the device time of the
kernels and memsets launched while ``power.mvdr_scan`` (a batch's rfft,
projections, rank-B update and maps) or ``power.pad`` (the upcast and
the pad back to the full mic axis) was the innermost span, per
``stage.batch`` of the traced session, ms."""

from portbench import span_device


def read(run):
    return span_device.per_batch_ms(run, ("power.mvdr_scan",
                                          "power.pad"))
