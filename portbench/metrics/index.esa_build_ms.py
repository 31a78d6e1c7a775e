"""index.esa_build_ms: the harness span around build_esa, the mean
over the window's jobs."""


def read(run):
    return run.span_mean_ms("esa.build")
