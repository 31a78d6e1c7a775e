"""greedy.k2r_ms: device time of the resident kernel K2r
(greedy_resident_kernel, by its name in the profiler's trace) a window
job; 0 where no lane went past K1."""


def read(run):
    t = run.trace
    if not t or not run.jobs:
        return None
    return 1e3 * sum(s for n, s in t.ops.items()
                     if "greedy_resident_kernel" in n) / len(run.jobs)
