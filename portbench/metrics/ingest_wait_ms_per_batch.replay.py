"""``ingest_wait_ms_per_batch.replay``: the time of the span
``ingest.wait`` (the full-rate stage waiting on the ring for its frames)
per ``stage.batch`` of the traced window, ms."""

from portbench import spans


def read(run):
    return spans.per_batch_ms(("ingest.wait",))
