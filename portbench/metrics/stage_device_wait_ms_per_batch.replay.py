"""``stage_device_wait_ms_per_batch.replay``: the time the full-rate
stage blocks on the card, the spans ``stage.slot_wait`` (a pinned slot's
last copy) and ``stage.finish_wait`` (the batch before's results),
per ``stage.batch`` of the traced window, ms."""

from portbench import spans


def read(run):
    return spans.per_batch_ms(("stage.slot_wait", "stage.finish_wait"))
