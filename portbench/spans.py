"""The program's own spans (``utils.profiling.report()`` of the port),
for the per-layer metrics that read them after a traced run: the spans
of the newest ``torch.profiler`` session that recorded CPU activity,
the traced window's.  A tree whose program has no span report gives
nothing, and the metric is left out of the line."""

from __future__ import annotations


def per_batch_ms(names, key: str = "total_s"):
    """The ``key`` time (``total_s`` or ``self_s``) of the spans
    ``names``, summed, per ``stage.batch``, ms; None where the program
    keeps no report, no batch ran or none of the spans did."""
    try:
        from zybo_rt_sampler_image_detection_torch.utils import profiling
    except ImportError:
        return None
    report = getattr(profiling, "report", None)
    if report is None:
        return None
    rep = report()
    batches = rep.get("stage.batch", {}).get("n", 0)
    found = [rep[name][key] for name in names if name in rep]
    if not batches or not found:
        return None
    return 1e3 * sum(found) / batches
