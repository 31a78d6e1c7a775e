"""greedy.retry_share: the lanes of the port's greedy.window spans whose
window is wider than the first (2,048 symbols), as a share of the lanes
at the first window: the flanks whose best point came near the clipped
window's edge and were extended again 8x wider, over the window's
jobs."""

from portbench.program_spans import records

FIRST = 2048


def read(run):
    recs = records(run)
    if not recs:
        return None
    first = sum(r.attrs["lanes"] for r in recs
                if r.name == "greedy.window" and r.attrs["cap"] == FIRST)
    wider = sum(r.attrs["lanes"] for r in recs
                if r.name == "greedy.window" and r.attrs["cap"] > FIRST)
    return 100.0 * wider / first if first else None
