"""Job runner: `gt seed_extend` all against all through the port, the
read set of one of the inputs' walks a job, in turn (the warm-up takes
the inputs' `warm` file): ``Encseq.from_files([reads])`` (as `-ii`
loads the index), then ``seed_extend(reads, None, params)`` on the
card, its matches rendered as gt's default output lines.

Checked: the lines of a sample of the window's jobs, drawn from the
seed, against the plain reference (reference/seed_extend.py) of each
job's own read file. Every line must belong to a pair of sequences
whose seeds pass the diagonal-band filter, and on a sample of those
pairs (drawn from the seed; `segments` over all kept jobs) the lines
must equal the reference's, in order.
"""

from __future__ import annotations

import numpy as np

from ..reference.fasta import read_records
from ..reference.seed_extend import Plan


class Job:
    def __init__(self, ctx):
        from genometools_torch.core.encseq import Encseq
        from genometools_torch.match.seed_extend import (SeedExtendParams,
                                                         seed_extend)
        from genometools_torch.ops import xdrop_batch
        self.ctx = ctx
        self.fastas = ctx.inputs["fastas"]
        self.walks, self.warm_walk = ctx.inputs["walks"], ctx.inputs["warm"]
        self.read_bp = ctx.inputs["read_bp"]
        self.params = ctx.config["params"]
        self._read, self._extend = Encseq.from_files, seed_extend
        self._make_params = SeedExtendParams
        self._stats = xdrop_batch
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
            # one string a read set: kept jobs add no objects for the
            # interpreter's collector to walk
            self.kept.offer((i, k), (g, "\n".join(lines)))
        return {"read_bp": self.read_bp * len(walk)}

    def reset_counters(self) -> None:
        self._stats.reset_stats()
        self.matches = 0

    def counters(self) -> dict:
        s = self._stats.stats
        return {"xdrop_lanes": s["kernel_lanes"] + s["host_lanes"],
                "matches": self.matches}

    def _plan(self, g: int, segments: int):
        plan = Plan(read_records(self.fastas[g]), self.params)
        n = min(segments, len(plan.segments))
        pick = self.ctx.rng(f"segments{g}").choice(len(plan.segments), n,
                                                   replace=False)
        return plan, [plan.segments[i] for i in np.sort(pick)]

    def check(self, device) -> dict:
        check = self.ctx.cell["check"]
        per_job = check["segments"] // check["jobs_kept"]
        by_input: dict = {}
        for _, (g, text) in self.kept.items():
            by_input.setdefault(g, []).append(
                text.split("\n") if text else [])
        foreign = differing = 0
        for g, outputs in sorted(by_input.items()):
            plan, sample = self._plan(g, per_job * len(outputs))
            want = {s: plan.lines(s) for s in sample}
            f, d = _compare(plan, want, outputs)
            foreign, differing = foreign + f, differing + d
        return {"foreign_lines": (foreign, 0),
                "segments_differing": (differing, 0)}

    def control(self, device) -> dict:
        """The reference with an X-drop below-score one lower (it gives
        up on alignments sooner) in the program's place, on the first
        walk's read set."""
        plan, sample = self._plan(self.walks[0][0],
                                  self.ctx.cell["check"]["segments"])
        want = {s: plan.lines(s) for s in sample}
        got = [line for s in sample
               for line in plan.lines(s, below=plan.below - 1)]
        foreign, differing = _compare(plan, want, [got])
        return {"foreign_lines": (foreign, 0),
                "segments_differing": (differing, 0)}


def _compare(plan, want: dict, outputs: list[list[str]]):
    """(lines outside every pair the reference's filter keeps, sampled
    pairs whose lines differ), summed over the outputs."""
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
