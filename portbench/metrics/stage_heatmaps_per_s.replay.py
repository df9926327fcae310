"""``stage_heatmaps_per_s.replay``: the frames whose batch the full-rate
stage finished in the measured window, over the window's seconds on the
host's clock, heatmaps/s: the rate the host copy chain and the card give
together, in the replay cells."""


def read(run):
    return run.e2e.get("heatmaps_per_s")
