"""``power_host_ms_per_batch.replay``: the time of the span
``power.program`` (the host's time to enqueue the power program: the
pad, the kernel's inputs, the launch) per ``stage.batch`` of the traced
window, ms."""

from portbench import spans


def read(run):
    return spans.per_batch_ms(("power.program",))
