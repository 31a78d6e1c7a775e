"""read_bp_per_s: the read set's bp a job, summed over the window's
jobs, over the time from the window's start to the last job's end."""


def read(run):
    return run.rate("read_bp")
