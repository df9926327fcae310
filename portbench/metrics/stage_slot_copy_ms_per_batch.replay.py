"""``stage_slot_copy_ms_per_batch.replay``: the time of the span
``stage.slot_copy`` (the batch's copy into the stage's pinned slot) per
``stage.batch`` of the traced window, ms."""

from portbench import spans


def read(run):
    return spans.per_batch_ms(("stage.slot_copy",))
