"""``stage_cpu_ms_per_batch.replay``: CPU time of the full-rate stage's
thread (``/proc/self/task/<tid>/stat``, user + system) over the measured
window, per batch finished in it, ms."""


def read(run):
    n = run.layer.get("window_batches", 0)
    if not n or "stage_cpu_s" not in run.layer:
        return None
    return 1e3 * run.layer["stage_cpu_s"] / n
