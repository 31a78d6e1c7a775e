"""greedy.rescue_share: the lanes of the port's greedy.rescue spans (K1's
wide-slot second launch, for lanes K1 left undone) as a share of the
lanes of its greedy.k1 spans, in %, over the window's jobs. A count; it
repeats exactly."""

from portbench.program_spans import records


def read(run):
    recs = records(run)
    if not recs:
        return None
    k1 = sum(r.attrs["lanes"] for r in recs if r.name == "greedy.k1")
    rescue = sum(r.attrs["lanes"] for r in recs if r.name == "greedy.rescue")
    return 100.0 * rescue / k1 if k1 else None
