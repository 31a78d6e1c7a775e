"""index.dtoh_ms: device-to-host copy time inside build_esa's spans
(profiler), the mean over the window's indexes."""


def read(run):
    spans = [s for s in run.trace.spans if s.name == "esa.build"] \
        if run.trace else []
    t = sum(s.dtoh_s for s in spans)
    return 1e3 * t / len(spans) if spans and t > 0 else None
