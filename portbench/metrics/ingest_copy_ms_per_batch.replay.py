"""``ingest_copy_ms_per_batch.replay``: the self time of the span
``ingest.read_batch`` (the copy out of the receiver's ring and the
channel slice, its wait for frames left out) per ``stage.batch`` of the
traced window, ms."""

from portbench import spans


def read(run):
    return spans.per_batch_ms(("ingest.read_batch",), "self_s")
