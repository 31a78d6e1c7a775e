"""seedext.k3_ms: device time of K3's kernel (xdrop_full_kernel, by its
name in the profiler's trace) a job."""


def read(run):
    t = run.trace
    if not t or not run.jobs:
        return None
    ms = 1e3 * sum(s for n, s in t.ops.items() if "xdrop_full_kernel" in n)
    return ms / len(run.jobs) if ms > 0 else None
