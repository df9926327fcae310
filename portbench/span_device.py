"""The device time the program's spans launched (``report()[name]
["device_self_s"]`` of the port's ``utils.profiling``), for the
per-layer metrics that read it after a traced run: the traced session's
kernels and memsets, each attributed when the session ended to the
innermost span open on its launching thread at its launch.  A tree whose
program keeps no such field gives nothing, and the metric is left out
of the line; a program that keeps it and failed to attribute the
session, or attributed no device time to a session on the card or none
to a thread that opened spans, raises."""

from __future__ import annotations


def per_batch_ms(run, names):
    """The ``device_self_s`` of the spans ``names``, summed, per
    ``stage.batch``, ms; None where the program keeps no such field, no
    batch ran or the sum is 0."""
    try:
        from zybo_rt_sampler_image_detection_torch.utils import profiling
    except ImportError:
        return None
    report = getattr(profiling, "report", None)
    session = getattr(profiling, "session", None)
    if report is None or session is None:
        return None
    ses = session()
    if "error" in ses:
        raise RuntimeError(f"no device time by span: {ses['error']}")
    device = getattr(run, "device", None)
    if getattr(device, "type", None) == "cuda":
        if not ses.get("device_s", 0.0) > 0:
            raise RuntimeError(f"the traced session on {device} attributed "
                               f"no device time: {ses}")
        # the launches' thread ids found the stage thread's spans
        if ses.get("launch_tid") not in {r[2] for r in profiling.timeline()}:
            raise RuntimeError(f"the thread that launched the most device "
                               f"work ({ses.get('launch_tid')}) opened no "
                               f"span: {ses}")
    rep = report()
    batches = rep.get("stage.batch", {}).get("n", 0)
    total = sum(rep[name].get("device_self_s", 0.0) for name in names
                if name in rep)
    if not batches or total <= 0:
        return None
    return 1e3 * total / batches
