"""index_s_p95: the 95th percentile of the wall time of every index
of the window's jobs, each from Encseq.from_files to suftab and lcptab
on the host."""

from portbench.harness import percentile


def read(run):
    times = [t for _, _, w in run.jobs for t in w.get("index_s", ())]
    return percentile(times, 95) if times else None
