"""``mvdr_host_ms_per_batch.stream``: the time of the spans
``power.mvdr_scan`` (a batch's scan: its projections, rank-B update and
maps), ``power.mvdr_d0`` (a full quadratic form) and
``power.mvdr_refresh`` (an exact refresh) of the streaming Capon
program, summed, per ``stage.batch`` of the traced window, ms: the
host's time to enqueue the estimator, the quadratic form and the refresh
at their own cadence."""

from portbench import spans


def read(run):
    return spans.per_batch_ms(("power.mvdr_scan", "power.mvdr_d0",
                               "power.mvdr_refresh"))
