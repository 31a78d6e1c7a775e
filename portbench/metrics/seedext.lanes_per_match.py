"""seedext.lanes_per_match: xdrop lanes extended (the port's
ops.xdrop_batch.stats: kernel_lanes plus host_lanes) over the matches
reported, over the window's jobs. A count; it repeats exactly."""


def read(run):
    c = run.counters
    return c["xdrop_lanes"] / c["matches"] if c.get("matches") else None
