"""Job runner: `gt seed_extend -extendgreedy` all against all on a read
set through the port, one order of the reads a job, in turn (the
warm-up takes the inputs' `warm` order): as jobs/seed_extend_greedy.py
runs a genome, ``Encseq.from_files([reads])`` then
``seed_extend(reads, None, params)`` on the card, its matches rendered
as gt's default output lines.

Checked: the lines of one of the window's jobs, drawn from the seed,
against the plain reference (reference/greedy.py) of that job's own read
file, every segment of it. Every line must belong to a pair of reads and
a strand (a segment) with seeds that pass the diagonal-band filter, and
every segment's lines must equal the reference's, in order. A read set
has some 20,000 segments, far too many for a plan each: the segments are
dealt out to at most `processes` processes, each of which builds one
plan of the file and walks its share together (``GreedyPlan.walk``).
"""

from __future__ import annotations

from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

from ..reference.fasta import read_records
from ..reference.greedy import GreedyPlan
from . import seed_extend_greedy


class Job(seed_extend_greedy.Job):

    def _walk(self, g: int, perc_mat_history: int | None = None):
        """The reference's plan of read order g and its lines by segment
        (perc_mat_history: in place of the table's)."""
        fasta = str(self.fastas[g])
        plan = GreedyPlan(read_records(fasta), self.params)
        n = min(len(plan.segments), self.ctx.cell["check"]["processes"])
        lines: dict = {}
        if not n:
            return plan, lines
        shares = [plan.segments[i::n] for i in range(n)]
        with ProcessPoolExecutor(n, get_context("spawn")) as pool:
            for part in pool.map(_share_lines, [fasta] * n,
                                 [self.params] * n, shares,
                                 [perc_mat_history] * n):
                lines.update(part)
        return plan, lines


def _share_lines(fasta: str, params: dict, segments,
                 perc_mat_history: int | None) -> dict:
    """{segment: its lines} of a share of the segments, from one plan
    (in a process of its own)."""
    plan = GreedyPlan(read_records(fasta), params)
    return plan.walk(segments, perc_mat_history)
