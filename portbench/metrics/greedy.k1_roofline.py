"""greedy.k1_roofline: the least time the card could take for the lanes
K1 took (the port's greedy.k1 spans, ops/greedy_batch.py) over the device
time of K1's kernel (greedy_full_kernel, the rescue's launches included),
in %, over the window's jobs. The least time is bytes-bound and does not
depend on the kernel: each lane reads its two flanks once, at 1 B a
symbol (the spans' `symbols`), and writes its result once, 7 int32 (28
B), at the card's HBM rate. The rescue's lanes are not counted again, so
a rescue that redoes work lowers the share. None where the spans carry
no `symbols` (a port without that count) or K1 took no time."""

from portbench.peaks import HBM_BYTES_PER_S
from portbench.program_spans import records

BYTES_PER_SYMBOL = 1
BYTES_PER_LANE = 7 * 4


def least_bytes(recs) -> int | None:
    """The bytes K1's lanes read and write, from the `lanes` and
    `symbols` of the greedy.k1 spans among the records (None where one
    lacks `symbols`)."""
    spans = [r for r in recs if r.name == "greedy.k1"]
    if any("symbols" not in r.attrs for r in spans):
        return None
    return sum(BYTES_PER_SYMBOL * r.attrs["symbols"] +
               BYTES_PER_LANE * r.attrs["lanes"] for r in spans)


def read(run):
    recs = records(run)
    if not recs:
        return None
    kernel = sum(s for n, s in run.trace.ops.items()
                 if "greedy_full_kernel" in n)
    least = least_bytes(recs)
    if not least or kernel <= 0:
        return None
    return 100.0 * least / HBM_BYTES_PER_S / kernel
