"""greedy.k1_ms: device time of K1's kernel (greedy_full_kernel, by its
name in the profiler's trace, the rescue launches included) a window
job; 0 where the window's lanes never fit K1."""


def read(run):
    t = run.trace
    if not t or not run.jobs:
        return None
    return 1e3 * sum(s for n, s in t.ops.items()
                     if "greedy_full_kernel" in n) / len(run.jobs)
