"""Xdrop alignment extension — cost-wave band scan.

The port's copy of ``genometools_tpu/ops/xdrop.py``
(JAX-free host code; the port imports nothing of the reference
package).

Behavioral spec: the reference's arbitrary-score X-drop extender
(`gt_evalxdroparbitscoresextend`, ref: src/match/xdrop.c:224-430) — the
reference is used as a *spec* only (tie-breaking, the drop test against
the running peak a fixed number of waves back, the stalled-wave
termination rule, band clipping); the formulation here is our own:

Each *wave* w holds, for every live diagonal, the furthest row any
alignment of total unit cost w has reached ("reach").  Waves are dense
numpy windows over the live diagonal range — the whole band advances
with vectorized source merges per wave, and only the match-run sprint
down each freshly advanced diagonal touches scalars.  History is a tiny
dict of the last max-unit-cost windows (the deepest any edit source
looks back).

Exactness bar: extension coordinates match the reference bit for bit
(golden seedextend/repfind suites).

Two implementations:
  * `xdrop_extend` below — the host engine / correctness oracle.
  * batched device versions in ops/xdrop_batch.py and ops/xdrop_pallas.py
    (fixed-shape lanes over many seeds).

Score model (ref: seed-extend.c:73-76 defaults): mat=2 mis=-1 ins=-2
del=-2; unit costs derived as in the reference's score-to-distance
reduction (ref: xdrop.c:129): scores doubled if mat is odd,
quantum = gcd(mat-mis, mat/2-ins, mat/2-del), unit costs = diffs/quantum,
score(total, w) = total*mat/2 - w*quantum.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class XdropScores:
    mat: int = 2
    mis: int = -1
    ins: int = -2
    del_: int = -2

    def distances(self):
        mat, mis, ins, dele = self.mat, self.mis, self.ins, self.del_
        if mat % 2:
            mat, mis, ins, dele = 2 * mat, 2 * mis, 2 * ins, 2 * dele
        g = math.gcd(math.gcd(mat - mis, mat // 2 - ins), mat // 2 - dele)
        return (mat - mis) // g, (mat // 2 - ins) // g, \
            (mat // 2 - dele) // g, g, mat


# the reference's sensitivity/error-rate -> xdropbelowscore parameter table
# (ref: src/match/seed-extend-params.h best_xdropbelow90..99; values are
# tuned constants, indexed [sensitivity-90][errorpercentage], errperc<=30)
_BEST_XDROPBELOW = {
    90: [0, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6],
    91: [0, 3, 3, 3, 4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6],
    92: [0, 3, 3, 4, 4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6],
    93: [0, 3, 3, 4, 4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6],
    94: [0, 3, 3, 4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 7],
    95: [0, 3, 3, 4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 7, 7],
    96: [0, 3, 3, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 7, 7, 7],
    97: [0, 3, 4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 7, 7, 7, 7, 7],
    98: [0, 3, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 7, 7, 7, 7, 7, 7],
    99: [0, 3, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 6, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7],
}


def optimal_xdrop_belowscore(errorpercentage: int, sensitivity: int) -> int:
    """ref: gt_optimalxdropbelowscore (seed-extend.c:55)."""
    s = min(max(sensitivity, 90), 99)
    return _BEST_XDROPBELOW[s][min(errorpercentage, 30)]


@dataclass
class XdropBest:
    ivalue: int
    jvalue: int
    score: int
    best_d: int
    best_k: int


def _match_run(u: np.ndarray, v: np.ndarray, i: int, j: int) -> int:
    """How many rows does u[i:] match v[j:] for?  Only equal *regular*
    symbols match (special codes >= 4 never equal anything, matching the
    reference's wildcard rule, ref: seqabstract.c).  Compares in chunks
    so long perfect runs stay vectorized."""
    n, m = len(u), len(v)
    total, chunk = 0, 64
    while True:
        a = u[i + total:i + total + chunk]
        b = v[j + total:j + total + chunk]
        span = min(a.size, b.size)
        if span == 0:
            return total
        eq = (a[:span] == b[:span]) & (a[:span] < 4)
        miss = np.flatnonzero(~eq)
        if miss.size:
            return total + int(miss[0])
        total += span
        if span < chunk:
            return total
        chunk = min(chunk * 4, 4096)


def xdrop_extend(u: np.ndarray, v: np.ndarray, belowscore: int,
                 scores: XdropScores = XdropScores()) -> XdropBest:
    """One-direction extension: how far do prefixes of u and v align?

    u, v: uint8 code arrays, already oriented (pass reversed slices for a
    left extension).  Cost-wave band scan (see module docstring).
    """
    m, n = len(u), len(v)
    if m == 0 or n == 0:
        return XdropBest(0, 0, 0, 0, 0)
    sub_cost, ins_cost, del_cost, quantum, mat2 = scores.distances()
    half = mat2 // 2
    goal_diag = m - n                 # the diagonal where u runs out last
    UNSEEN = -max(m, n)               # "no front on this diagonal" row
    NEG = -(1 << 62)                  # below any candidate row
    # the drop test compares against the peak this many waves back
    lookback = (belowscore + half) // quantum + 1
    # waves where no diagonal advanced are tolerated up to the deepest
    # edit-source look-back minus one, then the band is declared dead
    stall_limit = max(sub_cost, ins_cost, del_cost) - 1
    keep = max(sub_cost, ins_cost, del_cost)

    def grade(total: int, wave: int) -> int:
        return total * half - wave * quantum

    run0 = _match_run(u, v, 0, 0)
    peak = XdropBest(run0, run0, grade(2 * run0, 0), 0, 0)
    if run0 >= m or run0 >= n:
        return peak                   # a sequence is exhausted already
    waves = {0: (0, np.array([run0], np.int64))}
    peak_log = [peak.score]           # best score as of each wave
    lo = hi = 0                       # live diagonal range
    w = 0
    stall = 0

    while lo <= hi:
        w += 1
        diags = np.arange(lo - 1, hi + 2)
        nd = diags.size

        def rows_at(wave: int, at: np.ndarray) -> np.ndarray:
            ent = waves.get(wave)
            out = np.full(at.size, UNSEEN, np.int64)
            if ent is None:
                return out
            base, arr = ent
            ix = at - base
            ok = (ix >= 0) & (ix < arr.size)
            out[ok] = arr[ix[ok]]
            return out

        # merge the three edit sources; each is gated by the band range
        # and by its source wave's own diagonal reach
        cand = np.full(nd, NEG, np.int64)
        sourced = np.zeros(nd, bool)
        pw = w - del_cost             # consume a u symbol: diag-1, +1 row
        if pw >= 0:
            ok = (diags > lo) & (diags - 1 >= -pw) & (diags - 1 <= pw)
            cand = np.where(ok, np.maximum(cand, rows_at(pw, diags - 1) + 1),
                            cand)
            sourced |= ok
        pw = w - sub_cost             # substitute: same diag, +1 row
        if pw >= 0:
            ok = (diags >= lo) & (diags <= hi) & (np.abs(diags) <= pw)
            cand = np.where(ok, np.maximum(cand, rows_at(pw, diags) + 1),
                            cand)
            sourced |= ok
        pw = w - ins_cost             # consume a v symbol: diag+1, same row
        if pw >= 0:
            ok = (diags < hi) & (diags + 1 >= -pw) & (diags + 1 <= pw)
            cand = np.where(ok, np.maximum(cand, rows_at(pw, diags + 1)),
                            cand)
            sourced |= ok

        reach = np.full(nd, UNSEEN, np.int64)
        alive = cand >= 0
        # the drop test: kill fronts whose score fell more than
        # belowscore under the peak as of `lookback` waves ago
        if w - lookback > 0:
            floor = peak_log[w - lookback] - belowscore
            alive &= (cand + (cand - diags)) * half - w * quantum >= floor
        # a diagonal only advances if it beat the previous wave's front
        # and stayed inside both sequences; band-edge diagonals are new
        # and always advance.  Everyone else carries the old front.
        prev = rows_at(w - 1, diags)
        fresh = alive & ((diags <= -w) | (diags >= w) |
                         ((prev < cand) & (cand <= np.minimum(m, n + diags))))
        carry = alive & ~fresh
        reach[carry] = prev[carry]
        # the wave moved if any diagonal was source-less, advanced, or
        # carried — only all-killed waves count toward the stall limit
        moved = bool((~sourced).any() or alive.any())
        for t in np.flatnonzero(fresh):
            i, d = int(cand[t]), int(diags[t])
            j = i - d
            if i < m and j < n:       # sprint down the diagonal
                r = _match_run(u, v, i, j)
                i += r
                j += r
            reach[t] = i
            sc = grade(i + j, w)
            if sc > peak.score:       # first diagonal wins ties
                peak = XdropBest(i, j, sc, w, d)
        waves[w] = (lo - 1, reach)
        waves.pop(w - keep, None)

        if moved:
            stall = 0
        else:
            stall += 1
            if stall > stall_limit:
                break
        peak_log.append(peak.score)
        # complete alignment: u exhausted on the goal diagonal
        if -w <= goal_diag <= w:
            t = goal_diag - (lo - 1)
            if 0 <= t < nd and reach[t] == m:
                break
        # shrink the band to the live diagonals …
        live = np.flatnonzero(reach > UNSEEN)
        if live.size:
            lo = int(diags[live[0]])
            hi = int(diags[live[-1]])
        # … then clip diagonals past a sequence end: below a diagonal
        # that exhausted v nothing can improve, likewise above one that
        # exhausted u (innermost such diagonal on each side)
        done_v = np.flatnonzero((diags <= 0) & (diags >= lo) &
                                (reach == n + diags))
        if done_v.size:
            lo = int(diags[done_v[-1]])
        done_u = np.flatnonzero((diags >= 0) & (diags <= hi) &
                                (reach == m))
        if done_u.size:
            hi = int(diags[done_u[0]])
    return peak


def xdrop_extend_bruteforce(u: np.ndarray, v: np.ndarray, belowscore: int,
                            scores: XdropScores = XdropScores()):
    """Banded DP oracle (exhaustive over all prefix pairs within
    distance bound): best score over alignments of (u-prefix,
    v-prefix). Ignores the X-drop pruning, so it upper-bounds
    xdrop_extend's score — used to check the wave recurrence."""
    ulen, vlen = len(u), len(v)
    sub_cost, ins_cost, del_cost, quantum, mat2 = scores.distances()
    half = mat2 // 2
    INF = 10 ** 9
    D = np.full((ulen + 1, vlen + 1), INF, np.int64)
    D[0, 0] = 0
    for i in range(ulen + 1):
        for j in range(vlen + 1):
            if i < ulen and j < vlen and u[i] == v[j] and u[i] < 4:
                D[i + 1, j + 1] = min(D[i + 1, j + 1], D[i, j])
            if i < ulen and j < vlen:
                D[i + 1, j + 1] = min(D[i + 1, j + 1], D[i, j] + sub_cost)
            if i < ulen:
                D[i + 1, j] = min(D[i + 1, j], D[i, j] + del_cost)
            if j < vlen:
                D[i, j + 1] = min(D[i, j + 1], D[i, j] + ins_cost)
    best = 0
    for i in range(ulen + 1):
        for j in range(vlen + 1):
            if D[i, j] < INF:
                best = max(best, (i + j) * half - D[i, j] * quantum)
    return best
