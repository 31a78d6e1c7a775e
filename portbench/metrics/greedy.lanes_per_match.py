"""greedy.lanes_per_match: greedy lanes extended (the port's
ops.greedy_batch.stats: K1 and its rescue, the resident kernel, the
host-driven chunk loop and the host engine) over the matches reported,
over the window's jobs. A count; it repeats exactly."""


def read(run):
    c = run.counters
    return c["greedy_lanes"] / c["matches"] if c.get("matches") else None
