"""Job runner: `gt suffixerator -dna -suf -lcp -tis`'s read and sort
phases through the port. A job indexes the FASTA files of one of the
inputs' walks, in turn (one chromosome, or a pass over a collection);
the warm-up indexes the inputs' `warm` files. Each index is
``Encseq.from_files([fasta])``, then
``build_esa(enc, FWD, with_lcp=True)`` on the card, which leaves
suftab and lcptab in host memory. The index files are not written (the
config's `reduced` says why).

Checked: the suftab and lcptab of a sample of the window's indexes,
drawn from the seed, against the plain reference
(reference/suffix_array.py) of the same FASTA file, entry by entry.
"""

from __future__ import annotations

import time

import numpy as np

from ..reference.fasta import read_records, suffix_keys
from ..reference.suffix_array import sa_lcp


class Job:
    def __init__(self, ctx):
        from genometools_torch.core.encseq import FWD, Encseq
        from genometools_torch.index.esa import build_esa
        self.ctx = ctx
        self.fastas = ctx.inputs["fastas"]
        self.walks, self.warm_walk = ctx.inputs["walks"], ctx.inputs["warm"]
        self._read, self._build, self._fwd = Encseq.from_files, build_esa, FWD
        self.kept = ctx.reservoir(ctx.cell["check"]["jobs_kept"])

    def warm(self):
        """One job: every input's shapes, and the caching allocator's
        largest blocks."""
        for g in self.warm_walk:
            self._index(self.fastas[g])

    def _index(self, path):
        with self.ctx.span("encseq.read"):
            enc = self._read([str(path)])
        with self.ctx.span("esa.build"):
            esa = self._build(enc, self._fwd, with_lcp=True,
                              device=self.ctx.device)
        return enc.total_length + 1, esa

    def run(self, i: int) -> dict:
        """Work: the suffixes of the job, and each index's wall time."""
        total, times = 0, []
        for k, g in enumerate(self.walks[i % len(self.walks)]):
            t0 = time.perf_counter()
            suffixes, esa = self._index(self.fastas[g])
            times.append(time.perf_counter() - t0)
            total += suffixes
            self.kept.offer((i, k), (g, esa.suftab, esa.lcptab))
        return {"suffixes": total, "index_s": times}

    def counters(self) -> dict:
        return {}

    def reset_counters(self) -> None:
        pass

    def check(self, device) -> dict:
        """suftab and lcptab entries that differ from the reference's,
        over the kept jobs (an entry counts once per job; a table of the
        wrong length counts each of the reference's entries)."""
        sa_bad = lcp_bad = 0
        by_input: dict = {}
        for _, (g, suftab, lcptab) in self.kept.items():
            by_input.setdefault(g, []).append((suftab, lcptab))
        for g, tables in sorted(by_input.items()):
            rsa, rlcp = sa_lcp(suffix_keys(read_records(self.fastas[g])),
                               device)
            for suftab, lcptab in tables:
                sa_bad += _differing(suftab, rsa)
                lcp_bad += _differing(lcptab, rlcp)
        return {"suftab_mismatches": (sa_bad, 0),
                "lcptab_mismatches": (lcp_bad, 0)}

    def control(self, device) -> dict:
        """The reference sorting by the first 2**control_depth_log2
        keys only, ties left in position order (refinement skipped), in
        the program's place on the first inputs of the first walk."""
        check = self.ctx.cell["check"]
        sa_bad = lcp_bad = 0
        for g in self.walks[0][:check["jobs_kept"]]:
            keys = suffix_keys(read_records(self.fastas[g]))
            rsa, rlcp = sa_lcp(keys, device)
            csa, clcp = sa_lcp(keys, device, check["control_depth_log2"])
            sa_bad += _differing(csa, rsa)
            lcp_bad += _differing(clcp, rlcp)
        return {"suftab_mismatches": (sa_bad, 0),
                "lcptab_mismatches": (lcp_bad, 0)}


def _differing(got, want) -> int:
    if got is None or got.shape != want.shape:
        return int(want.size)
    return int(np.count_nonzero(got != want))
