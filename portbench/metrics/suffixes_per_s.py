"""suffixes_per_s: n + 1 suffixes a job, summed over the window's jobs,
over the time from the window's start to the last job's end."""


def read(run):
    return run.rate("suffixes")
