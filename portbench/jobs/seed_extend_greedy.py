"""Job runner: `gt seed_extend -extendgreedy` all against all through
the port, one variant of the genome a job, in turn (the warm-up takes
the inputs' `warm` variant): ``Encseq.from_files([genome])`` (as `-ii`
loads the index), then ``seed_extend(genome, None, params)`` on the
card, its matches rendered as gt's default output lines.

The cell needs the rounds' floor of the port's walk
(``match.seed_extend.ROUND_MIN``): without it a job of this genome
runs some 10^5 rounds of a few seeds and takes minutes (PERF.md), far
past the window, so a checkout without it fails at once.

Checked: the lines of one of the window's jobs, drawn from the seed,
against the plain reference (reference/greedy.py) of that job's own
genome file. Every line must belong to a pair of sequences and a strand
(a segment) with seeds that pass the diagonal-band filter, and every
segment's lines must equal the reference's, in order. The segments'
walks are independent and run in processes of their own, at most
`processes` at a time.
"""

from __future__ import annotations

from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

from ..reference.fasta import read_records
from ..reference.greedy import GreedyPlan


class Job:
    def __init__(self, ctx):
        from genometools_torch.core.encseq import Encseq
        from genometools_torch.match.seed_extend import (  # noqa: F401
            ROUND_MIN, SeedExtendParams, seed_extend)
        from genometools_torch.ops import greedy_batch
        self.ctx = ctx
        self.fastas = ctx.inputs["fastas"]
        self.walks, self.warm_walk = ctx.inputs["walks"], ctx.inputs["warm"]
        self.read_bp = ctx.inputs["read_bp"]
        self.params = ctx.config["params"]
        self._read, self._extend = Encseq.from_files, seed_extend
        self._make_params = SeedExtendParams
        self._stats = greedy_batch
        self.kept = ctx.reservoir(ctx.cell["check"]["jobs_kept"])
        self.matches = 0

    def _lines(self, g: int) -> list[str]:
        with self.ctx.span("encseq.read"):
            enc = self._read([str(self.fastas[g])])
        with self.ctx.span("seed_extend.job"):
            return [m.line() for m in self._extend(
                enc, None, self._make_params(**self.params),
                device=self.ctx.device)]

    def warm(self):
        for g in self.warm_walk:
            self._lines(g)

    def run(self, i: int) -> dict:
        walk = self.walks[i % len(self.walks)]
        for k, g in enumerate(walk):
            lines = self._lines(g)
            self.matches += len(lines)
            self.kept.offer((i, k), (g, "\n".join(lines)))
        return {"read_bp": self.read_bp * len(walk)}

    def reset_counters(self) -> None:
        self._stats.reset_stats()
        self.matches = 0

    def counters(self) -> dict:
        s = self._stats.stats
        return {"greedy_lanes": sum(s.values()),
                "resident_lanes": s["resident_lanes"],
                "host_lanes": s["host_lanes"], "matches": self.matches}

    def _walk(self, g: int, perc_mat_history: int | None = None):
        """The reference's plan of genome variant g and its lines by
        segment (perc_mat_history: in place of the table's)."""
        fasta = str(self.fastas[g])
        plan = GreedyPlan(read_records(fasta), self.params)
        if not plan.segments:
            return plan, {}
        workers = min(len(plan.segments),
                      self.ctx.cell["check"]["processes"])
        with ProcessPoolExecutor(workers, get_context("spawn")) as pool:
            lines = pool.map(_segment_lines, *zip(*(
                (fasta, self.params, s, perc_mat_history)
                for s in plan.segments)))
            return plan, dict(zip(plan.segments, lines))

    def check(self, device) -> dict:
        by_input: dict = {}
        for _, (g, text) in self.kept.items():
            by_input.setdefault(g, []).append(
                text.split("\n") if text else [])
        foreign = differing = 0
        for g, outputs in sorted(by_input.items()):
            plan, want = self._walk(g)
            f, d = _compare(plan, want, outputs)
            foreign, differing = foreign + f, differing + d
        return {"foreign_lines": (foreign, 0),
                "segments_differing": (differing, 0)}

    def control(self, device) -> dict:
        """The reference with perc_mat_history one lower (it extends on
        where gt trims) in the program's place, on the first walk's
        genome variant."""
        g = self.walks[0][0]
        plan, want = self._walk(g)
        _, got = self._walk(g, plan.pmh - 1)
        foreign, differing = _compare(
            plan, want, [[line for s in plan.segments for line in got[s]]])
        return {"foreign_lines": (foreign, 0),
                "segments_differing": (differing, 0)}


def _segment_lines(fasta: str, params: dict, segment,
                   perc_mat_history: int | None) -> list[str]:
    """One segment's lines from the reference (in a process of its
    own)."""
    plan = GreedyPlan(read_records(fasta), params)
    return plan.lines(segment, perc_mat_history)


def _compare(plan, want: dict, outputs: list[list[str]]):
    """(lines outside every segment the reference's filter keeps,
    segments whose lines differ from the reference's), summed over the
    outputs."""
    foreign = differing = 0
    for lines in outputs:
        got: dict = {}
        for line in lines:
            f = line.split()
            seg = (int(f[1]), int(f[5]), f[3])
            if seg not in plan.seeds:
                foreign += 1
            got.setdefault(seg, []).append(line)
        differing += sum(got.get(s, []) != w for s, w in want.items())
    return foreign, differing
