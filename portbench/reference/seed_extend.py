"""Plain reference of `gt seed_extend -extendxdrop` all against all.

Imports numpy alone. It works everything out again from the reads:
the seed length, the k-mers of both strands, the seed pairs, the
diagonal-band filter over every pair of sequences, then, for the pairs
it is asked about, the sequential walk of GenomeTools' seed_extend
(src/match/diagbandseed.c gt_diagbandseed_process_seeds,
seed-extend.c gt_extend_sesp, querymatch.c's filters and ordering)
with a scalar X-drop extension (src/match/xdrop.c
gt_evalxdroparbitscoresextend, at the default scores: match 2,
mismatch -1, insertion and deletion -2). Its output is gt's default
output line of each match.

A *segment* is one pair (a sequence, b sequence, strand): the walk is
sequential within a segment and independent across segments, so any
subset of segments can be checked alone.
"""

from __future__ import annotations

import math

import numpy as np

from .fasta import SPECIAL

# gt's xdrop below-score table rows for sensitivity 90..99, indexed by
# the error percentage 0..30 (src/match/seed-extend-params.h)
_XDROPBELOW = {
    90: "0333444444455555555556666666666",
    91: "0333444444555555555556666666666",
    92: "0334444444555555555566666666666",
    93: "0334444444555555555566666666666",
    94: "0334444445555555555666666666667",
    95: "0334444445555555556666666666677",
    96: "0334444455555555566666666666777",
    97: "0344444455555555666666666677777",
    98: "0344444555555556666666666777777",
    99: "0344445555555666666666777777777",
}


def xdrop_belowscore(errorpercentage: int, sensitivity: int) -> int:
    row = _XDROPBELOW[min(max(sensitivity, 90), 99)]
    return int(row[min(errorpercentage, 30)])


def default_seedlength(lengths: np.ndarray) -> int:
    """gt_seed_extend.c's default: log4 of the mean of the two sides'
    total lengths (with separators), at most the longest sequence and
    32, at least 2."""
    total = int(lengths.sum()) + max(lengths.size - 1, 0)
    log_avg = int(round(math.log(max(total, 2)) / math.log(4)))
    return max(min(log_avg, int(lengths.max()), 32), 2)


def strand_codes(seq: np.ndarray, reverse: bool) -> np.ndarray:
    """A sequence as read on the F strand, or reverse-complemented for
    the P strand (a special stays special)."""
    if not reverse:
        return seq
    r = seq[::-1]
    return np.where(r < SPECIAL, 3 - r, r).astype(np.uint8)


def kmers(seqs: list[np.ndarray], k: int, reverse: bool):
    """(code, seq, endpos) of every k-window without a special, endpos
    relative to its sequence's start in the strand's reading order."""
    lens = np.asarray([s.size for s in seqs], np.int64)
    starts = np.cumsum(lens + 1) - (lens + 1)
    flat = np.full(int((lens + 1).sum()), SPECIAL, np.uint8)
    for s, st in zip(seqs, starts.tolist()):
        flat[st:st + s.size] = strand_codes(s, reverse)
    nwin = flat.size - k + 1
    spec = np.concatenate([[0], np.cumsum(flat >= SPECIAL)])
    valid = spec[k:k + nwin] - spec[:nwin] == 0
    sym = np.minimum(flat, 3).astype(np.int64)
    code = np.zeros(nwin, np.int64)
    for j in range(k):
        code = code * 4 + sym[j:j + nwin]
    pos = np.flatnonzero(valid)
    seq = np.searchsorted(starts, pos, side="right") - 1
    return code[pos], seq, pos - starts[seq] + k - 1


def seed_pairs(a, b, mindist: int):
    """Every pair of equal k-mers with a from the a list and b from the
    b list that a self-comparison keeps (a's sequence before b's, or
    the same sequence with b at least `mindist` past a), sorted by
    (aseq, bseq, bpos, apos). Returns (aseq, bseq, apos, bpos)."""
    acode, aseq, apos = a
    bcode, bseq, bpos = b
    ao = np.argsort(acode, kind="stable")
    bo = np.argsort(bcode, kind="stable")
    ua, ia, na = np.unique(acode[ao], return_index=True, return_counts=True)
    ub, ib, nb = np.unique(bcode[bo], return_index=True, return_counts=True)
    common, ca, cb = np.intersect1d(ua, ub, assume_unique=True,
                                    return_indices=True)
    an, bn = na[ca], nb[cb]
    reps = an * bn
    grp = np.repeat(np.arange(common.size), reps)
    within = np.arange(int(reps.sum())) - np.repeat(np.cumsum(reps) - reps,
                                                    reps)
    ai = ao[ia[ca][grp] + within // bn[grp]]
    bi = bo[ib[cb][grp] + within % bn[grp]]
    pa_seq, pa_pos, pb_seq, pb_pos = aseq[ai], apos[ai], bseq[bi], bpos[bi]
    keep = (pa_seq < pb_seq) | ((pa_seq == pb_seq) &
                                (pa_pos + mindist <= pb_pos))
    pa_seq, pa_pos, pb_seq, pb_pos = (x[keep] for x in
                                      (pa_seq, pa_pos, pb_seq, pb_pos))
    order = np.lexsort((pa_pos, pb_pos, pb_seq, pa_seq))
    return pa_seq[order], pb_seq[order], pa_pos[order], pb_pos[order]


def diagband_select(aseq, bseq, apos, bpos, k, amaxlen, logw, mincov):
    """gt's diagonal-band filter: a seed is kept when the seeds of its
    band, together with those of the better neighbouring band, of the
    same sequence pair cover at least `mincov` positions of b. Within a
    band, in order of bpos, a seed covers min(k, bpos - previous bpos)
    new positions (k for the first)."""
    n = aseq.size
    if n == 0:
        return np.zeros(0, bool)
    brk = np.ones(n, bool)
    brk[1:] = (aseq[1:] != aseq[:-1]) | (bseq[1:] != bseq[:-1])
    seg = np.cumsum(brk) - 1
    band = ((amaxlen + bpos - apos) >> logw) + 1
    key = seg * (int(band.max()) + 2) + band
    order = np.argsort(key, kind="stable")
    ks, bs = key[order], bpos[order]
    first = np.ones(n, bool)
    first[1:] = ks[1:] != ks[:-1]
    contrib = np.full(n, k, np.int64)
    contrib[1:] = np.where(first[1:], k, np.minimum(k, bs[1:] - bs[:-1]))
    starts = np.flatnonzero(first)
    bkeys, cover = ks[starts], np.add.reduceat(contrib, starts)

    def covered(q):
        i = np.searchsorted(bkeys, q).clip(max=bkeys.size - 1)
        return np.where(bkeys[i] == q, cover[i], 0)
    return covered(key) + np.maximum(covered(key - 1),
                                     covered(key + 1)) >= mincov


class Plan:
    """The run's seeds after the filter, by segment: what the walk of
    any segment needs. `segments` lists every (aseq, bseq, strand) with
    at least one kept seed, in output order (F before P, then aseq,
    bseq)."""

    def __init__(self, reads: list[np.ndarray], params: dict):
        self.reads = reads
        self.lengths = np.asarray([r.size for r in reads], np.int64)
        self.k = params.get("seedlength") or default_seedlength(self.lengths)
        k = self.k
        self.mincov = int(2.5 * k)
        self.leastlen = params["userdefinedleastlength"]
        self.errperc = 100 - params["minidentity"]
        self.below = xdrop_belowscore(self.errperc, params["sensitivity"])
        logw = params.get("logdiagbandwidth", 6)
        amaxlen = int(self.lengths.max())
        fwd = kmers(reads, k, False)
        self.seeds = {}
        for strand, blist, mindist in (("F", fwd, k),
                                       ("P", kmers(reads, k, True), 0)):
            aseq, bseq, apos, bpos = seed_pairs(fwd, blist, mindist)
            sel = diagband_select(aseq, bseq, apos, bpos, k, amaxlen, logw,
                                  self.mincov)
            aseq, bseq, apos, bpos = (x[sel] for x in (aseq, bseq, apos,
                                                       bpos))
            if not aseq.size:
                continue
            brk = np.flatnonzero(np.concatenate(
                [[True], (aseq[1:] != aseq[:-1]) | (bseq[1:] != bseq[:-1])]))
            ends = np.append(brk[1:], aseq.size)
            for s0, s1 in zip(brk.tolist(), ends.tolist()):
                self.seeds[(int(aseq[s0]), int(bseq[s0]), strand)] = (
                    apos[s0:s1], bpos[s0:s1])
        self.segments = sorted(self.seeds, key=lambda s: (s[2] == "P",
                                                          s[0], s[1]))

    def lines(self, segment, below: int | None = None) -> list[str]:
        """The output lines of one segment, in gt's order; `below`
        replaces the X-drop below-score (for the control)."""
        aseq, bseq, strand = segment
        apos, bpos = self.seeds[segment]
        return walk(self.reads[aseq], strand_codes(self.reads[bseq],
                                                   strand == "P"),
                    aseq, bseq, strand, apos.tolist(), bpos.tolist(),
                    self.k, self.below if below is None else below,
                    self.errperc, self.leastlen)


def _score2distance(score: int, alignedlen: int) -> int:
    if score >= 0:
        return (alignedlen - score) // 3
    return -((alignedlen + score) // 3)


def walk(u, v, aseq, bseq, strand, apos, bpos, k, below, errperc,
         leastlen) -> list[str]:
    """The sequential skip / extend / accept walk over one segment's
    kept seeds (sorted by bpos, then apos). u is the a sequence, v the
    b sequence as read on the strand."""
    same = aseq == bseq
    # specials compare unequal to everything, each other included
    ub = np.where(u < SPECIAL, u, 0xFE).astype(np.uint8).tobytes()
    vb = np.where(v < SPECIAL, v, 0xFF).astype(np.uint8).tobytes()
    m, n = len(ub), len(vb)
    out = []
    has_prev, prev_b_end = False, -1
    for ap, bp in zip(apos, bpos):
        if has_prev and prev_b_end >= bp:
            continue
        db, qs = ap + 1 - k, bp + 1 - k
        if same and db + k - 1 >= qs:
            continue                      # overlapping instances
        ul = vl = sl = 0
        if db > 0 and qs > 0:
            voff = db + k if same else 0
            if qs - voff > 0:
                ul, vl, sl = xdrop(ub[:db][::-1], vb[voff:qs][::-1], below)
        urb = min(m, qs - vl) if same else m
        ur = vr = sr = 0
        if db + k < urb and qs + k < n:
            ur, vr, sr = xdrop(ub[db + k:urb], vb[qs + k:], below)
        has_prev = True
        line = None
        for mode in range(3):             # both sides, left only, right only
            l_ = (ul, vl, sl) if mode != 2 else (0, 0, 0)
            r_ = (ur, vr, sr) if mode != 1 else (0, 0, 0)
            dblen = k + l_[0] + r_[0]
            qlen = k + l_[1] + r_[1]
            alen = dblen + qlen
            score = 2 * k + l_[2] + r_[2]
            dist = _score2distance(score, alen)
            a_start, b_start = db - l_[0], qs - l_[1]
            if mode == 0:
                prev_b_end = b_start + qlen - 1
            err = 200.0 * dist / alen
            if err > errperc or alen < 2 * leastlen:
                continue
            b_fwd = b_start if strand == "F" else n - b_start - qlen
            if same and not (a_start < b_fwd + (strand == "P")):
                break                     # shown in its other orientation
            line = (f"{dblen} {aseq} {a_start} {strand} {qlen} {bseq} "
                    f"{b_fwd} {score} {dist} {100.0 - err:.2f}")
            break
        if line is not None:
            out.append(line)
    return out


def _run(u: bytes, v: bytes, i: int, j: int) -> int:
    """Length of the common prefix of u[i:] and v[j:]."""
    lim = min(len(u) - i, len(v) - j)
    if lim <= 0 or u[i] != v[j]:
        return 0
    if u[i:i + lim] == v[j:j + lim]:
        return lim
    lo, hi = 1, lim                       # u[i:i+lo] equal, [:hi] not
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if u[i:i + mid] == v[j:j + mid]:
            lo = mid
        else:
            hi = mid
    return lo


def xdrop(u: bytes, v: bytes, below: int) -> tuple[int, int, int]:
    """X-drop extension of u against v from their first symbols at unit
    edit costs (match 2, mismatch -1, indels -2: every edit costs one
    quantum of 3). Wave w holds, for each live diagonal d = i - j, the
    furthest row i reached at w edits; a diagonal's front dies once its
    score falls more than `below` under the best score as of
    (below + 1) // 3 + 1 waves back. Returns (i, j, score) of the first
    best point."""
    m, n = len(u), len(v)
    if m == 0 or n == 0:
        return 0, 0, 0
    r0 = _run(u, v, 0, 0)
    bi, bj, bs = r0, r0, 2 * r0
    if r0 >= m or r0 >= n:
        return bi, bj, bs
    unseen = -max(m, n)
    lookback = (below + 1) // 3 + 1
    goal = m - n
    prev_base, prev = 0, [r0]
    peak_log = [bs]
    lo = hi = 0
    w = 0
    while lo <= hi:
        w += 1
        pw = w - 1
        base = lo - 1
        nd = hi - lo + 3
        reach = [unseen] * nd
        floor = peak_log[w - lookback] - below if w > lookback else None
        moved = False

        def at(d):
            t = d - prev_base
            return prev[t] if 0 <= t < len(prev) else unseen

        for t in range(nd):
            d = base + t
            cand, sourced = None, False
            if d > lo and -pw <= d - 1 <= pw:       # deletion
                cand, sourced = at(d - 1) + 1, True
            if lo <= d <= hi and -pw <= d <= pw:     # mismatch
                c = at(d) + 1
                cand, sourced = c if cand is None else max(cand, c), True
            if d < hi and -pw <= d + 1 <= pw:       # insertion
                c = at(d + 1)
                cand, sourced = c if cand is None else max(cand, c), True
            alive = cand is not None and cand >= 0
            if alive and floor is not None:
                alive = 2 * cand - d - 3 * w >= floor
            if alive or not sourced:
                moved = True
            if not alive:
                continue
            old = at(d)
            if d <= -w or d >= w or (old < cand <= min(m, n + d)):
                i = cand
                j = i - d
                if i < m and j < n:
                    r = _run(u, v, i, j)
                    i, j = i + r, j + r
                reach[t] = i
                sc = i + j - 3 * w
                if sc > bs:
                    bi, bj, bs = i, j, sc
            else:
                reach[t] = old
        if not moved:
            break
        peak_log.append(bs)
        if -w <= goal <= w and 0 <= goal - base < nd and \
                reach[goal - base] == m:
            break                         # u used up on the goal diagonal
        live = [t for t in range(nd) if reach[t] > unseen]
        if live:
            lo, hi = base + live[0], base + live[-1]
        done_v = [t for t in range(nd)
                  if lo <= base + t <= 0 and reach[t] == n + base + t]
        if done_v:
            lo = base + done_v[-1]
        done_u = [t for t in range(nd)
                  if 0 <= base + t <= hi and reach[t] == m]
        if done_u:
            hi = base + done_u[0]
        prev_base, prev = base, reach
    return bi, bj, bs
