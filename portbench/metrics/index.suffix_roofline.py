"""index.suffix_roofline: the least time the card could take for the
window's indexes over the device kernel time inside build_esa's spans
(profiler; kernels only, copies left out), in %. The least time is
bytes-bound: (n + 1) x 9 B at the card's HBM rate, the symbols read
once (1 B) and int32 suftab and lcptab written once (8 B), whatever
implements the sort."""

from portbench.peaks import HBM_BYTES_PER_S

BYTES_PER_SUFFIX = 9


def read(run):
    spans = [s for s in run.trace.spans if s.name == "esa.build"] \
        if run.trace else []
    kernel = sum(s.kernel_s for s in spans)
    if kernel <= 0:
        return None
    least = run.total("suffixes") * BYTES_PER_SUFFIX / HBM_BYTES_PER_S
    return 100.0 * least / kernel
