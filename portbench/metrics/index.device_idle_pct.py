"""index.device_idle_pct: the share of the traced window with no
kernel and no copy on the card (profiler)."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t and t.busy_s else None
