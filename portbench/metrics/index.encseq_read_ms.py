"""index.encseq_read_ms: the harness span around Encseq.from_files,
the mean over the window's indexes."""


def read(run):
    return run.span_mean_ms("encseq.read")
