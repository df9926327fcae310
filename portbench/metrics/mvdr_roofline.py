"""``mvdr_roofline``: the streaming Capon program's share of its roofline,
%.

The least time the card needs for one batch of the cell's ``mvdr``
heatmaps (:func:`portbench.roofline_mvdr.mvdr_bound_s`, from the
configuration's shapes and its ``"mvdr"`` constants alone) over the
device time of the kernels the stage launched per batch in the traced
window (the union of kernel and memset intervals, copies left out: in
the stream cell the power program is the only work the device runs)."""

from portbench import roofline_mvdr


def read(run):
    s, batches = run.trace_summary, run.layer.get("traced_batches", 0)
    if not s or not batches or s["kernel_s"] <= 0:
        return None
    bound = roofline_mvdr.mvdr_bound_s(
        run.cfg, run.config["mvdr"], run.layer["batch"],
        run.layer["channels"], run.notes.get("device_kind", ""))
    if bound is None:
        return None
    return 100.0 * bound / (s["kernel_s"] / batches)
