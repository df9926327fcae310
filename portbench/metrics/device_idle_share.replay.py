"""``device_idle_share.replay``: the share of the traced window in which
no kernel, copy or memset ran on the device, %, in the replay cells."""


def read(run):
    s = run.trace_summary
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
