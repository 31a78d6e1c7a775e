"""Greedy extension: Myers O(nd) difference fronts with trimming and

The port's copy of ``genometools_tpu/ops/greedy.py``
(JAX-free host code; the port imports nothing of the reference
package).
match-history polishing.

Semantics equivalent of the reference front-prune engine
(ref: src/match/ft-front-prune.c:633 front_prune_edist_inplace,
ft-polish.c polishing tables), mirrored exactly:

* front entry per diagonal: row (u-positions consumed), 64-bit match
  history (1 = match), history size, max_mismatches; diag = vpos - upos
* per generation d: new entry at diag k takes, in priority order on
  equal rows, INSERTION from F_{d-1}(k-1) (row unchanged), MISMATCH from
  F_{d-1}(k) (row+1), DELETION from F_{d-1}(k+1) (row+1) — matching the
  reference's candidate ordering in front_next_inplace; every step shifts
  a 0 into the history, then the greedy match extension shifts in 1s
* trimming: entries whose aligned length lags the generation maximum by
  more than `maxalignedlendifference`, or whose recent-history match
  fraction drops below `perc_mat_history`%, are cut from both flanks
  (ref: trimthisentry/trim_front); if everything is trimmed the
  extension "dies out" and returns distance = ulen+vlen+1
* polishing: the best polished point is the largest aligned length whose
  match history passes GT_HISTORY_IS_POLISHED — both halves of the
  pol_size most recent bits must not end below their running maximum
  (ref: ft-polish.h:35, fill_polishing_info)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


_POL_CACHE: dict = {}


@dataclass
class PolishingInfo:
    """ref: GtFtPolishing_info (ft-polish.h:15, construction ft-polish.c)."""

    cut_depth: int
    pol_size: int
    mask: int
    match_score: int
    difference_score: int
    diff_from_max: np.ndarray  # int32[2^cut_depth]
    score_sum: np.ndarray

    @classmethod
    def new(cls, errorpercentage: float, history_size: int = 64,
            matchscore_bias: float = 1.0) -> "PolishingInfo":
        key = (errorpercentage, history_size, matchscore_bias)
        hit = _POL_CACHE.get(key)
        if hit is not None:
            return hit
        cut_depth = 15 if history_size == 0 else min(history_size // 2, 15)
        entries = 1 << cut_depth
        match_score = int(20.0 * errorpercentage * matchscore_bias)
        difference_score = 1000 - match_score
        diff_from_max = np.zeros(entries, np.int32)
        score_sum = np.zeros(entries, np.int32)
        # iterative fill (ref: fill_polishing_info): bits MSB-first;
        # score walks +match_score for 1, -difference_score for 0
        for prefix in range(entries):
            # maxscore tracks proper prefixes (incl. the empty prefix 0),
            # mirroring the recursion's update order
            score = 0
            maxscore = 0
            for b in range(cut_depth - 1, -1, -1):
                if score > maxscore:
                    maxscore = score
                bit = (prefix >> b) & 1
                score += match_score if bit else -difference_score
            diff_from_max[prefix] = score - maxscore
            score_sum[prefix] = score
        obj = cls(cut_depth, 2 * cut_depth, entries - 1, match_score,
                  difference_score, diff_from_max, score_sum)
        _POL_CACHE[key] = obj
        return obj

    def history_is_polished(self, history: int) -> bool:
        lo = history & self.mask
        hi = (history >> self.cut_depth) & self.mask
        return bool(self.diff_from_max[lo] >= 0 and
                    self.score_sum[lo] + self.diff_from_max[hi] >= 0)


@dataclass
class PolishedPoint:
    alignedlen: int = 0
    row: int = 0
    distance: int = 0
    max_mismatches: int = 0


class _Front:
    __slots__ = ("row", "hist", "hsize", "mm")

    def __init__(self, row=0, hist=0, hsize=0, mm=0):
        self.row = row
        self.hist = hist
        self.hsize = hsize
        self.mm = mm

    def copy(self):
        return _Front(self.row, self.hist, self.hsize, self.mm)


_U64 = (1 << 64) - 1


FT_EOP_MISMATCH = 1
FT_EOP_INSERTION = 2
FT_EOP_DELETION = 4


def greedy_extend(u: np.ndarray, v: np.ndarray, *,
                  max_history: int = 64,
                  perc_mat_history: int = 55,
                  maxalignedlendifference: int = 30,
                  seedlength: int = 0,
                  pol_info: PolishingInfo | None = None,
                  trim: bool = True,
                  trace: dict | None = None) -> tuple[int, PolishedPoint]:
    """One-direction greedy extension of prefixes of u vs v.

    Returns (distance, best_polished_point). distance = ulen+vlen+1 when
    the front died out before reaching the end.
    """
    ulen, vlen = len(u), len(v)
    sumlen = ulen + vlen
    if pol_info is None:
        pol_info = PolishingInfo.new(0.0, max_history)
    minmatchpercentage128 = (perc_mat_history * 128) // 100 + \
        (0 if (perc_mat_history * 128) % 100 == 0 else 1)
    hist_mask = _U64 if max_history == 64 else (1 << max_history) - 1
    best = PolishedPoint()

    def lcp(row, vpos):
        l = 0
        while row + l < ulen and vpos + l < vlen and \
                u[row + l] == v[vpos + l] and u[row + l] < 4:
            l += 1
        return l

    def add_matches(fv: _Front, diag: int):
        c = lcp(fv.row, fv.row + diag)
        if c > 0:
            mask = _U64 if c >= max_history else (1 << c) - 1
            fv.hist = ((fv.hist << c) | mask) & _U64
            if fv.hsize < max_history:
                fv.hsize = min(fv.hsize + c, max_history)
            fv.row += c

    def shift_diff(fv: _Front):
        if fv.hsize < max_history:
            fv.hsize += 1
        fv.hist = (fv.hist << 1) & _U64

    # fronts: dict diag -> _Front over the valid (untrimmed) window
    f0 = _Front()
    if seedlength >= 64:
        f0.hist = _U64
    else:
        f0.hist = (1 << seedlength) - 1
    f0.hsize = min(max_history, seedlength)
    front = {0: f0}
    lo = hi = 0
    row0 = f0.row
    add_matches(f0, 0)
    if trace is not None:
        # per-cell backreference bits + match run for the traceback
        # (ref: ft-front-generation.c backref_table)
        trace[(0, 0)] = (0, f0.row - row0)
    distance = 0

    while True:
        if distance > 0:
            new = {}
            for k in range(lo - 1, hi + 2):
                cand = None
                bits = 0
                # INSERTION from prev k-1 (row unchanged)
                if (k - 1) in front:
                    cand = front[k - 1].copy()
                    bits = FT_EOP_INSERTION
                # MISMATCH from prev k (row+1)
                if k in front:
                    c = front[k]
                    if cand is None or cand.row < c.row + 1:
                        cand = c.copy()
                        cand.row += 1
                        cand.mm += 1
                        bits = FT_EOP_MISMATCH
                    elif cand.row == c.row + 1:
                        cand.mm = max(cand.mm, c.mm + 1)
                        bits |= FT_EOP_MISMATCH
                # DELETION from prev k+1 (row+1)
                if (k + 1) in front:
                    c = front[k + 1]
                    if cand is None or cand.row < c.row + 1:
                        cand = c.copy()
                        cand.row += 1
                        bits = FT_EOP_DELETION
                    elif cand.row == c.row + 1:
                        # ref keeps the ins/mis winner's max_mismatches on
                        # a deletion tie (ft-front-prune.c:395-407 has no
                        # mm update in the == branch)
                        bits |= FT_EOP_DELETION
                if cand is None:
                    continue
                shift_diff(cand)
                row_before = cand.row
                add_matches(cand, k)
                if trace is not None:
                    trace[(distance, k)] = (bits, cand.row - row_before)
                new[k] = cand
            front = new
            lo -= 1
            hi += 1

        maxalignedlen = max(2 * f.row + k for k, f in front.items())

        # trimming (ref: trim_front both directions)
        if trim:
            minlen = max(0, maxalignedlen - maxalignedlendifference)

            def keep(k):
                f = front[k]
                if f.row > ulen or f.row + k > vlen:
                    return False
                if 2 * f.row + k < minlen:
                    return False
                need = (f.hsize * minmatchpercentage128) >> 7
                if bin(f.hist & hist_mask).count("1") < need:
                    return False
                return True

            while lo <= hi and not keep(lo):
                del front[lo]
                lo += 1
            while hi >= lo and not keep(hi):
                del front[hi]
                hi -= 1
            if lo > hi:
                return sumlen + 1, best  # died out
        else:
            # still enforce sequence bounds
            for k in list(front):
                f = front[k]
                if f.row > ulen or f.row + k > vlen:
                    del front[k]
            lo = min(front)
            hi = max(front)

        # polished-point update (ref: ft_update_trace_and_polished)
        for k in range(lo, hi + 1):
            f = front[k]
            alignedlen = 2 * f.row + k
            if alignedlen > best.alignedlen:
                filled = f.hist
                if f.hsize < pol_info.pol_size:
                    shift = pol_info.pol_size - f.hsize
                    filled |= (((1 << shift) - 1) << f.hsize)
                if pol_info.history_is_polished(filled):
                    best = PolishedPoint(alignedlen, f.row, distance, f.mm)

        end_k = vlen - ulen
        if abs(end_k) <= distance and lo <= end_k <= hi and \
                front[end_k].row == ulen:
            return distance, best
        if distance >= sumlen:
            return distance, best
        distance += 1


def greedy_params_table(sensitivity: int, errorpercentage: int):
    """(perc_mat_history, maxalignedlendifference) defaults
    (ref: best_percmathistory_maxalilendiff*, seed-extend-params.h).
    Filled lazily from the generated table below."""
    from .greedy_params import BEST_GREEDY_PARAMS
    s = min(max(sensitivity, 90), 99)
    return BEST_GREEDY_PARAMS[s][min(errorpercentage, 30)]


def edit_distance_oracle(u: np.ndarray, v: np.ndarray) -> int:
    """Plain DP edit distance (wildcards never match) — test oracle."""
    ulen, vlen = len(u), len(v)
    D = np.arange(vlen + 1, dtype=np.int64)
    for i in range(1, ulen + 1):
        prev = D.copy()
        D[0] = i
        for j in range(1, vlen + 1):
            m = 0 if (u[i - 1] == v[j - 1] and u[i - 1] < 4) else 1
            D[j] = min(prev[j - 1] + m, prev[j] + 1, D[j - 1] + 1)
    return int(D[vlen])
