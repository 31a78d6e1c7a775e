"""Pairwise alignment utilities.

The port's copy of ``genometools_tpu/match/alignment.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference alignment stack
(ref: src/extended/alignment.c, linearalign.c / linearalign_affinegapcost.c,
squarealign.c, `gt linspace_align` tool src/tools/gt_linspace_align.c).

Provides global (Needleman-Wunsch) and local (Smith-Waterman) alignment
with linear or affine gap costs, Hirschberg linear-space traceback, edit
operation lists (the reference's GtMultieoplist) and CIGAR rendering.
Cost model mirrors the reference's scorehandler: either unit costs
(distance) or (match, mismatch, gap_open, gap_extend) scores.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NEG = -(10 ** 9)


@dataclass
class AlignmentResult:
    score: int
    # edit operations as (op, count) runs; op in "M" (match/mismatch),
    # "I" (insertion into v / gap in u), "D" (deletion from u / gap in v)
    eops: list[tuple[str, int]]
    ustart: int = 0
    uend: int = 0
    vstart: int = 0
    vend: int = 0

    def cigar(self, distinguish: bool = False, u=None, v=None) -> str:
        """CIGAR string; distinguish=True uses =/X for match/mismatch
        (ref: ft-eoplist.c CIGAR/X output)."""
        if not distinguish:
            return "".join(f"{c}{op}" for op, c in self.eops)
        out = []
        ui, vi = self.ustart, self.vstart
        for op, c in self.eops:
            if op == "M":
                run_op, run = None, 0
                for _ in range(c):
                    cur = "=" if u[ui] == v[vi] and u[ui] < 4 else "X"
                    if cur == run_op:
                        run += 1
                    else:
                        if run_op:
                            out.append(f"{run}{run_op}")
                        run_op, run = cur, 1
                    ui += 1
                    vi += 1
                if run_op:
                    out.append(f"{run}{run_op}")
            else:
                out.append(f"{c}{op}")
                if op == "D":
                    ui += c
                else:
                    vi += c
        return "".join(out)

    def counts(self, u, v):
        """(matches, mismatches, indels)."""
        m = mm = ind = 0
        ui, vi = self.ustart, self.vstart
        for op, c in self.eops:
            if op == "M":
                for _ in range(c):
                    if u[ui] == v[vi] and u[ui] < 4:
                        m += 1
                    else:
                        mm += 1
                    ui += 1
                    vi += 1
            else:
                ind += c
                if op == "D":
                    ui += c
                else:
                    vi += c
        return m, mm, ind


def _compress(ops: list[str]) -> list[tuple[str, int]]:
    out = []
    for op in ops:
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + 1)
        else:
            out.append((op, 1))
    return out


def global_alignment(u: np.ndarray, v: np.ndarray, matchscore: int = 0,
                     mismatchscore: int = -1, gapscore: int = -1
                     ) -> AlignmentResult:
    """NW global alignment, full matrix with traceback
    (ref: squarealign.c / linearalign distance mode with unit costs)."""
    ulen, vlen = len(u), len(v)
    S = np.zeros((ulen + 1, vlen + 1), np.int64)
    S[:, 0] = np.arange(ulen + 1) * gapscore
    S[0, :] = np.arange(vlen + 1) * gapscore
    for i in range(1, ulen + 1):
        sub = np.where((v[:] == u[i - 1]) & (u[i - 1] < 4),
                       matchscore, mismatchscore)
        for j in range(1, vlen + 1):
            S[i, j] = max(S[i - 1, j - 1] + sub[j - 1],
                          S[i - 1, j] + gapscore,
                          S[i, j - 1] + gapscore)
    ops = []
    i, j = ulen, vlen
    while i > 0 or j > 0:
        if i > 0 and j > 0 and S[i, j] == S[i - 1, j - 1] + (
                matchscore if (u[i - 1] == v[j - 1] and u[i - 1] < 4)
                else mismatchscore):
            ops.append("M")
            i -= 1
            j -= 1
        elif i > 0 and S[i, j] == S[i - 1, j] + gapscore:
            ops.append("D")
            i -= 1
        else:
            ops.append("I")
            j -= 1
    return AlignmentResult(int(S[ulen, vlen]), _compress(ops[::-1]),
                           0, ulen, 0, vlen)


def edit_distance(u: np.ndarray, v: np.ndarray) -> int:
    """Unit-cost distance, linear space (ref: gt_squarededistunit)."""
    r = global_alignment(u, v, 0, -1, -1)
    return -r.score


def local_alignment(u: np.ndarray, v: np.ndarray, matchscore: int = 2,
                    mismatchscore: int = -2, gapscore: int = -2
                    ) -> AlignmentResult:
    """Smith-Waterman local alignment (ref: gt_computelocalalignment)."""
    ulen, vlen = len(u), len(v)
    S = np.zeros((ulen + 1, vlen + 1), np.int64)
    besti = bestj = 0
    for i in range(1, ulen + 1):
        for j in range(1, vlen + 1):
            sub = matchscore if (u[i - 1] == v[j - 1] and u[i - 1] < 4) \
                else mismatchscore
            S[i, j] = max(0, S[i - 1, j - 1] + sub, S[i - 1, j] + gapscore,
                          S[i, j - 1] + gapscore)
            if S[i, j] > S[besti, bestj]:
                besti, bestj = i, j
    ops = []
    i, j = besti, bestj
    while i > 0 and j > 0 and S[i, j] > 0:
        sub = matchscore if (u[i - 1] == v[j - 1] and u[i - 1] < 4) \
            else mismatchscore
        if S[i, j] == S[i - 1, j - 1] + sub:
            ops.append("M")
            i -= 1
            j -= 1
        elif i > 0 and S[i, j] == S[i - 1, j] + gapscore:
            ops.append("D")
            i -= 1
        else:
            ops.append("I")
            j -= 1
    return AlignmentResult(int(S[besti, bestj]), _compress(ops[::-1]),
                           i, besti, j, bestj)


def global_alignment_affine(u: np.ndarray, v: np.ndarray,
                            matchscore: int = 0, mismatchscore: int = -4,
                            gap_opening: int = -4, gap_extension: int = -1
                            ) -> AlignmentResult:
    """Gotoh affine-gap global alignment
    (ref: linearalign_affinegapcost.c)."""
    ulen, vlen = len(u), len(v)
    R = np.full((ulen + 1, vlen + 1), NEG, np.int64)  # ends in match
    D = np.full((ulen + 1, vlen + 1), NEG, np.int64)  # ends in gap in v
    I = np.full((ulen + 1, vlen + 1), NEG, np.int64)  # ends in gap in u
    R[0, 0] = 0
    for i in range(1, ulen + 1):
        D[i, 0] = gap_opening + i * gap_extension
    for j in range(1, vlen + 1):
        I[0, j] = gap_opening + j * gap_extension
    for i in range(1, ulen + 1):
        for j in range(1, vlen + 1):
            sub = matchscore if (u[i - 1] == v[j - 1] and u[i - 1] < 4) \
                else mismatchscore
            best_prev = max(R[i - 1, j - 1], D[i - 1, j - 1], I[i - 1, j - 1])
            R[i, j] = best_prev + sub
            D[i, j] = max(R[i - 1, j] + gap_opening + gap_extension,
                          D[i - 1, j] + gap_extension,
                          I[i - 1, j] + gap_opening + gap_extension)
            I[i, j] = max(R[i, j - 1] + gap_opening + gap_extension,
                          I[i, j - 1] + gap_extension,
                          D[i, j - 1] + gap_opening + gap_extension)
    # traceback
    ops = []
    i, j = ulen, vlen
    state = int(np.argmax([R[i, j], D[i, j], I[i, j]]))
    score = int(max(R[i, j], D[i, j], I[i, j]))
    while i > 0 or j > 0:
        if state == 0:
            sub = matchscore if (u[i - 1] == v[j - 1] and u[i - 1] < 4) \
                else mismatchscore
            prev = R[i, j] - sub
            ops.append("M")
            i -= 1
            j -= 1
            state = int(np.argmax([
                R[i, j] if R[i, j] == prev else NEG,
                D[i, j] if D[i, j] == prev else NEG,
                I[i, j] if I[i, j] == prev else NEG]))
            if i == 0 and j == 0:
                break
        elif state == 1:
            if D[i, j] == D[i - 1, j] + gap_extension:
                nstate = 1
            elif D[i, j] == R[i - 1, j] + gap_opening + gap_extension:
                nstate = 0
            else:
                nstate = 2
            ops.append("D")
            i -= 1
            state = nstate
        else:
            if I[i, j] == I[i, j - 1] + gap_extension:
                nstate = 2
            elif I[i, j] == R[i, j - 1] + gap_opening + gap_extension:
                nstate = 0
            else:
                nstate = 1
            ops.append("I")
            j -= 1
            state = nstate
    return AlignmentResult(score, _compress(ops[::-1]), 0, ulen, 0, vlen)


def global_alignment_linear_space(u: np.ndarray, v: np.ndarray,
                                  matchscore: int = 0,
                                  mismatchscore: int = -1,
                                  gapscore: int = -1) -> AlignmentResult:
    """Hirschberg divide-and-conquer: O(min(m,n)) space traceback
    (ref: linearalign.c gt_linearalign_compute_generic)."""

    def nw_lastrow(a, b):
        prev = np.arange(len(b) + 1, dtype=np.int64) * gapscore
        for i in range(1, len(a) + 1):
            cur = np.empty(len(b) + 1, np.int64)
            cur[0] = i * gapscore
            sub = np.where((b == a[i - 1]) & (a[i - 1] < 4),
                           matchscore, mismatchscore)
            for j in range(1, len(b) + 1):
                cur[j] = max(prev[j - 1] + sub[j - 1], prev[j] + gapscore,
                             cur[j - 1] + gapscore)
            prev = cur
        return prev

    def rec(a, b):
        if len(a) == 0:
            return ["I"] * len(b)
        if len(b) == 0:
            return ["D"] * len(a)
        if len(a) == 1:
            r = global_alignment(a, b, matchscore, mismatchscore, gapscore)
            return [op for op, c in r.eops for _ in range(c)]
        mid = len(a) // 2
        left = nw_lastrow(a[:mid], b)
        right = nw_lastrow(a[mid:][::-1], b[::-1])[::-1]
        split = int(np.argmax(left + right))
        return rec(a[:mid], b[:split]) + rec(a[mid:], b[split:])

    ops = rec(u, v)
    # score recompute
    score = 0
    ui = vi = 0
    for op in ops:
        if op == "M":
            score += matchscore if (u[ui] == v[vi] and u[ui] < 4) \
                else mismatchscore
            ui += 1
            vi += 1
        else:
            score += gapscore
            ui += op == "D"
            vi += op == "I"
    return AlignmentResult(score, _compress(ops), 0, len(u), 0, len(v))


class ScoreMatrix:
    """Protein/DNA score matrix (ref: src/core/score_matrix.c; parses the
    BLOSUM62-style format in testdata/BLOSUM62)."""

    def __init__(self, chars: str, matrix: np.ndarray):
        self.chars = chars
        self.matrix = matrix
        self._index = {c: i for i, c in enumerate(chars)}

    @classmethod
    def parse(cls, text: str) -> "ScoreMatrix":
        rows = []
        chars = None
        order = []
        for line in text.splitlines():
            if not line.strip() or line.startswith("#"):
                continue
            parts = line.split()
            if chars is None:
                chars = "".join(parts)
                continue
            order.append(parts[0])
            rows.append([int(x) for x in parts[1:1 + len(chars)]])
        m = np.array(rows, np.int64)
        return cls("".join(order), m)

    def score(self, a: str, b: str) -> int:
        return int(self.matrix[self._index[a.upper()],
                               self._index[b.upper()]])


def global_alignment_scored(u: str, v: str, matrix: "ScoreMatrix",
                            gapscore: int = -8) -> int:
    """NW with a score matrix (protein alignment path of
    gt linspace_align -protein)."""
    ulen, vlen = len(u), len(v)
    S = np.zeros((ulen + 1, vlen + 1), np.int64)
    S[:, 0] = np.arange(ulen + 1) * gapscore
    S[0, :] = np.arange(vlen + 1) * gapscore
    for i in range(1, ulen + 1):
        for j in range(1, vlen + 1):
            S[i, j] = max(S[i - 1, j - 1] + matrix.score(u[i - 1], v[j - 1]),
                          S[i - 1, j] + gapscore,
                          S[i, j - 1] + gapscore)
    return int(S[ulen, vlen])
