"""Plain reference of `gt seed_extend -extendgreedy` all against all.

Imports numpy alone. The seeds, the seed pairs and the diagonal-band
filter are those of the X-drop reference (reference/seed_extend.py,
whose `Plan` this module's `GreedyPlan` extends); the walk over a
segment's kept seeds is GenomeTools' sequential skip / extend / accept
walk (src/match/diagbandseed.c gt_diagbandseed_process_seeds,
seed-extend.c gt_extend_sesp, querymatch.c's filters and ordering),
with the greedy extension of src/match/ft-front-prune.c
front_prune_edist_inplace in place of X-drop: Myers' O(nd) difference
fronts, pruned by the match history and by the aligned-length
difference, and the best point that passes ft-polish.c's polishing
test. A match's distance is the sum of its two flanks' distances at
their best points and its score is alignedlen - 3 * distance
(seed-extend.c, greedy branch). Its output is gt's default output
line of each match.

Departures from GenomeTools, each on purpose:

- Only the 97 % sensitivity row of seed-extend-params.h's
  (perc_mat_history, maxalignedlendifference) table is kept, as
  constants (gt's default sensitivity); other rows raise.
- The fronts of many extensions are held together in numpy arrays,
  one generation at a time (gt extends one seed at a time, in an
  in-place array of front entries); a diagonal's entry is its row, its
  64-bit match history, the history's size and the most mismatches on
  a path to it. On equal
  rows a new entry takes its predecessor in gt's order: insertion,
  mismatch, deletion; a mismatch that ties an insertion raises the
  mismatch count only, a deletion that ties changes nothing.
- Trims cut entries only from the two ends of the front, as
  ft-front-prune.c's trim_front does; an entry inside the front that
  fails a trim test stays, and takes part in the polishing test.
- Flanks are whole: from the seed to the start (left) or end (right)
  of its sequence, bounded as gt bounds them within one sequence.
  Nothing is clipped, so no window retry exists here.
- Seeds are extended before the walk reaches them, some for nothing
  (GreedyPlan); the walk itself, and so every line, is gt's.
- A wildcard (any symbol that is not a, c, g or t) matches nothing,
  another wildcard included.
"""

from __future__ import annotations

import numpy as np

from .fasta import SPECIAL
from .seed_extend import Plan, strand_codes

# seed-extend-params.h best_percmathistory_maxalilendiff97: the
# (perc_mat_history, maxalignedlendifference) pair for the error
# percentage 0..30 at sensitivity 97
_GREEDY97 = [
    (0, 0), (94, 1), (89, 1), (79, 1), (86, 2), (83, 2), (79, 2), (74, 2),
    (79, 3), (76, 3), (73, 3), (69, 3), (68, 3), (73, 4), (71, 4), (69, 4),
    (66, 4), (63, 4), (67, 5), (66, 5), (64, 5), (63, 5), (61, 5), (58, 5),
    (57, 5), (54, 5), (53, 5), (59, 6), (58, 6), (54, 6), (53, 6)]

_NEG = -(1 << 40)            # the row of a predecessor that is not there
_RUN_MAX = 4096              # the widest window a match run is read in
# set bits of each byte value
_POP8 = np.asarray([bin(i).count("1") for i in range(256)], np.int64)


def greedy_params(errorpercentage: int, sensitivity: int) -> tuple[int, int]:
    """(perc_mat_history, maxalignedlendifference) of gt's table."""
    if sensitivity != 97:
        raise ValueError("the reference keeps the sensitivity 97 row only")
    return _GREEDY97[min(errorpercentage, 30)]


class Polishing:
    """ft-polish.c's polishing test: the `cut_depth` most recent bits of
    a match history and the `cut_depth` before them, each scored
    +match_score for a match and -difference_score for another edit,
    must neither end below their running maximum (fill_polishing_info
    builds the two tables over every pattern of cut_depth bits, most
    recent bit last)."""

    def __init__(self, errorpercentage: float, history: int = 64):
        self.cut_depth = 15 if history == 0 else min(history // 2, 15)
        self.pol_size = 2 * self.cut_depth
        self.mask = (1 << self.cut_depth) - 1
        match = int(20.0 * errorpercentage)
        diff = 1000 - match
        bits = np.arange(1 << self.cut_depth, dtype=np.int64)
        score = np.zeros(bits.size, np.int64)
        best = np.zeros(bits.size, np.int64)
        for b in range(self.cut_depth - 1, -1, -1):
            best = np.maximum(best, score)
            score += np.where((bits >> b) & 1 == 1, match, -diff)
        self.diff_from_max = score - best
        self.score_sum = score

    def polished(self, hist: np.ndarray, hsize: np.ndarray) -> np.ndarray:
        """The test on each history (int64 bit patterns); a history
        shorter than pol_size is read with matches in its missing
        bits."""
        short = np.maximum(self.pol_size - hsize, 0)
        h = hist | (((1 << short) - 1) << np.minimum(hsize, 63))
        lo = h & self.mask
        hi = (h >> self.cut_depth) & self.mask
        return (self.diff_from_max[lo] >= 0) & \
            (self.score_sum[lo] + self.diff_from_max[hi] >= 0)


class Extension:
    """What every extension of one run shares: the symbols and the
    parameters. A flank is (base, step, length) into `symbols`: its
    t-th symbol is symbols[base + step * t]. Codes 0-3 are a, c, g, t;
    anything else is a wildcard."""

    def __init__(self, symbols: np.ndarray, perc_mat_history: int,
                 maxalignedlendifference: int, history: int,
                 pol: Polishing):
        self.symbols = np.ascontiguousarray(symbols, np.uint8)
        self.mad = maxalignedlendifference
        self.history = history
        self.hmask = -1 if history == 64 else (1 << history) - 1
        self.mmp128 = (perc_mat_history * 128) // 100 + \
            (0 if (perc_mat_history * 128) % 100 == 0 else 1)
        self.pol = pol

    def runs(self, lane, flanks, i, j) -> np.ndarray:
        """For each entry: how many symbols from u[i] and v[j] on are
        equal, neither a wildcard, within both flanks of its lane."""
        ub, us, ul, vb, vs, vl = (f[lane] for f in flanks)
        S, top = self.symbols, self.symbols.size - 1
        room = np.minimum(ul - i, vl - j)
        a0, b0 = ub + us * i, vb + vs * j
        out = np.zeros(i.size, np.int64)
        act = np.flatnonzero(room > 0)
        w = 1
        while act.size:
            t = out[act, None] + np.arange(w)
            a = S[np.clip(a0[act, None] + us[act, None] * t, 0, top)]
            b = S[np.clip(b0[act, None] + vs[act, None] * t, 0, top)]
            eq = (a == b) & (a < SPECIAL) & (t < room[act, None])
            full = eq.all(1)
            out[act] += np.where(full, w, np.argmin(eq, 1))
            act = act[full]
            w = min(4 * w, _RUN_MAX)
        return out


class Lanes:
    """Greedy extensions advanced together, a generation at a time
    (src/match/ft-front-prune.c front_prune_edist_inplace). The fronts
    of all lanes lie end to end in flat arrays, a lane's `wd` entries
    from its lowest diagonal `lo` (v position less u position) up; an
    entry holds its row (u symbols consumed), its match history (the
    bit pattern of an int64, the most recent edit in bit 0), the
    history's size and the most mismatches on a path to it. Finished
    lanes leave; their best polished points are written to `out` at
    their ids."""

    def __init__(self, ext: Extension, flanks, seedlength, out: dict,
                 ids):
        """Generation 0 of the flanks (ub, us, ul, vb, vs, vl arrays)
        with the given seed lengths."""
        self.ext, self.out = ext, out
        self.flanks = tuple(np.asarray(f, np.int64) for f in flanks)
        self.ids = np.asarray(ids, np.int64)
        n = self.ids.size
        H = ext.history
        zero = np.zeros(n, np.int64)
        c = ext.runs(np.arange(n), self.flanks, zero, zero)
        seed = np.asarray(seedlength, np.int64)
        h = np.where(seed >= 64, -1, (1 << np.minimum(seed, 63)) - 1)
        cc = np.minimum(c, 63)
        self.hist = np.where(c == 0, h, np.where(
            c >= H, -1, (h << cc) | ((1 << cc) - 1)))
        self.row = c
        self.hsize = np.minimum(np.minimum(seed, H) + c, H)
        self.mm = zero.copy()
        self.lo, self.wd = zero.copy(), np.ones(n, np.int64)
        self.best = np.zeros((4, n), np.int64)   # alignedlen, row, d, mm
        self.d = 0
        self._check()

    def __len__(self):
        return self.ids.size

    def _entries(self, wd):
        """(each entry's lane, its slot, each lane's first entry)."""
        start = np.cumsum(wd) - wd
        lane = np.repeat(np.arange(wd.size), wd)
        return lane, np.arange(lane.size) - start[lane], start

    def _step(self):
        """Generation d: each diagonal lo - 1 .. hi + 1 takes its
        predecessor by row, in gt's order on equal rows (insertion from
        k - 1, mismatch from k, deletion from k + 1); the edit shifts a
        0 into the history, the diagonal's match run then 1s."""
        H = self.ext.history
        old = np.cumsum(self.wd) - self.wd
        lane, j, _ = self._entries(self.wd + 2)
        w, base = self.wd[lane], old[lane]

        def source(back):
            t = j - back
            ok = (t >= 0) & (t < w)
            return ok, np.where(ok, base + t, 0)
        ok, i = source(2)                                   # insertion
        row = np.where(ok, self.row[i], _NEG)
        hist, hsize, mm = self.hist[i], self.hsize[i], self.mm[i]
        ok, i = source(1)                                   # mismatch
        mrow = np.where(ok, self.row[i] + 1, _NEG)
        mmm = self.mm[i] + 1
        take = mrow > row
        mm = np.where(take, mmm, np.where(ok & (mrow == row),
                                          np.maximum(mm, mmm), mm))
        row = np.where(take, mrow, row)
        hist = np.where(take, self.hist[i], hist)
        hsize = np.where(take, self.hsize[i], hsize)
        ok, i = source(0)                                   # deletion
        drow = np.where(ok, self.row[i] + 1, _NEG)
        take = drow > row
        row = np.where(take, drow, row)
        hist = np.where(take, self.hist[i], hist)
        hsize = np.where(take, self.hsize[i], hsize)
        mm = np.where(take, self.mm[i], mm)
        self.lo -= 1
        self.wd += 2
        c = self.ext.runs(lane, self.flanks, row, row + self.lo[lane] + j)
        cc = np.minimum(c, 63)
        self.hist = np.where(c >= H, -1,
                             ((hist << 1) << cc) | ((1 << cc) - 1))
        self.hsize = np.minimum(hsize + 1 + c, H)
        self.row, self.mm = row + c, mm

    def _check(self):
        """Trim both ends of each front, finish the lanes whose front
        died or reached both ends, and take each lane's best polished
        point."""
        ext = self.ext
        ub, us, ul, vb, vs, vl = self.flanks
        lane, j, start = self._entries(self.wd)
        ks = self.lo[lane] + j
        al = 2 * self.row + ks
        minlen = np.maximum(np.maximum.reduceat(al, start) - ext.mad, 0)
        pop = _POP8[(self.hist & ext.hmask).view(np.uint8).reshape(
            -1, 8)].sum(1)
        keep = (self.row <= ul[lane]) & (self.row + ks <= vl[lane]) & \
            (al >= minlen[lane]) & (pop >= (self.hsize * ext.mmp128) >> 7)
        first = np.minimum.reduceat(np.where(keep, j, 1 << 40), start)
        last = np.maximum.reduceat(np.where(keep, j, -1), start)
        alive = last >= 0
        sel = (j >= first[lane]) & (j <= last[lane])
        self.row, self.hist, self.hsize, self.mm, al, lane = (
            x[sel] for x in (self.row, self.hist, self.hsize, self.mm, al,
                             lane))
        self.lo = np.where(alive, self.lo + first, self.lo)
        self.wd = np.where(alive, last - first + 1, 0)
        up = np.flatnonzero(al > self.best[0][lane])
        if up.size:
            up = up[ext.pol.polished(self.hist[up], self.hsize[up])]
        if up.size:
            top = np.full(len(self), _NEG)
            np.maximum.at(top, lane[up], al[up])
            up = up[al[up] == top[lane[up]]]
            up = up[np.unique(lane[up], return_index=True)[1]]
            ln = lane[up]
            self.best[0, ln] = al[up]
            self.best[1, ln] = self.row[up]
            self.best[2, ln] = self.d
            self.best[3, ln] = self.mm[up]
        end = vl - ul
        at = end - self.lo
        inside = alive & (np.abs(end) <= self.d) & (at >= 0) & \
            (at < self.wd)
        first_entry = np.cumsum(self.wd) - self.wd
        reached = np.zeros(len(self), bool)
        reached[inside] = self.row[first_entry[inside] + at[inside]] == \
            ul[inside]
        done = ~alive | reached | (self.d >= ul + vl)
        if done.any():
            i = self.ids[done]
            for k, name in enumerate(("alignedlen", "row", "distance",
                                      "mismatches")):
                self.out[name][i] = self.best[k, done]
            self.out["died"][i] = ~alive[done]
            self.out["done"][i] = True
            self._keep(~done, lane)

    def _keep(self, sel, lane=None):
        """Keep only the lanes `sel` (lane: each entry's lane)."""
        if lane is None:
            lane = self._entries(self.wd)[0]
        on = sel[lane]
        self.row, self.hist, self.hsize, self.mm = (
            x[on] for x in (self.row, self.hist, self.hsize, self.mm))
        self.ids = self.ids[sel]
        self.flanks = tuple(f[sel] for f in self.flanks)
        self.lo, self.wd, self.best = self.lo[sel], self.wd[sel], \
            self.best[:, sel]

    def run(self, gens: int | None = None) -> None:
        """Advance every lane until it is finished, or `gens`
        generations at most."""
        stop = None if gens is None else self.d + gens
        while len(self) and (stop is None or self.d < stop):
            self.d += 1
            self._step()
            self._check()

    def split(self, ids) -> "Lanes":
        """The lanes with these ids, taken out into a Lanes of their
        own (the same generation)."""
        sel = np.isin(self.ids, ids)
        part = Lanes.__new__(Lanes)
        part.ext, part.out, part.d = self.ext, self.out, self.d
        on = sel[self._entries(self.wd)[0]]
        part.row, part.hist, part.hsize, part.mm = (
            x[on] for x in (self.row, self.hist, self.hsize, self.mm))
        part.ids = self.ids[sel]
        part.flanks = tuple(f[sel] for f in self.flanks)
        part.lo, part.wd, part.best = self.lo[sel], self.wd[sel], \
            self.best[:, sel]
        self._keep(~sel)
        return part


def results(n: int) -> dict:
    """The arrays Lanes writes its finished lanes to."""
    out = {k: np.zeros(n, np.int64) for k in ("alignedlen", "row",
                                              "distance", "mismatches")}
    out["died"] = np.zeros(n, bool)
    out["done"] = np.zeros(n, bool)
    return out


def greedy_extend(u: np.ndarray, v: np.ndarray, seedlength: int,
                  perc_mat_history: int, maxalignedlendifference: int,
                  history: int, pol: Polishing):
    """One greedy extension of u against v from their first symbols.
    Returns (alignedlen, row, distance, mismatches, died): the best
    polished point (row: symbols of u, alignedlen - row of v) and
    whether every entry of the front was trimmed before it reached
    both ends."""
    ext = Extension(np.concatenate([u, v]).astype(np.uint8),
                    perc_mat_history, maxalignedlendifference, history, pol)
    out = results(1)
    Lanes(ext, ([0], [1], [u.size], [u.size], [1], [v.size]), [seedlength],
          out, [0]).run()
    return tuple(int(out[k][0]) for k in ("alignedlen", "row", "distance",
                                          "mismatches", "died"))


class GreedyPlan(Plan):
    """Plan's seeds after the filter, walked with the greedy extension.

    The walk of a segment is sequential, but a seed's extension does not
    depend on the walk's state, only whether the walk reaches it. So
    segments are walked together in rounds: each round extends, for
    every segment still walking, the next ROUND seeds its walk could
    reach, in one set of Lanes, each lane for at most SHORT generations
    (a lane on random sequence dies well before); the walks then go on
    in order, and a lane still running when its walk reaches its seed
    is run to its end then. A seed extended for nothing changes no
    line."""

    ROUND = 256
    SHORT = 32

    def __init__(self, reads: list[np.ndarray], params: dict):
        super().__init__(reads, params)
        self.history = params.get("history", 64)
        self.pmh, self.mad = greedy_params(self.errperc,
                                           params["sensitivity"])
        self.pol = Polishing(float(self.errperc), self.history)
        # every sequence on both strands in one pool, a wildcard between
        parts, self.base, pos = [np.full(1, SPECIAL, np.uint8)], {}, 1
        for strand in "FP":
            for i, r in enumerate(reads):
                self.base[(i, strand)] = pos
                parts += [strand_codes(r, strand == "P"),
                          np.full(1, SPECIAL, np.uint8)]
                pos += r.size + 1
        self.symbols = np.concatenate(parts)

    def lines(self, segment, perc_mat_history: int | None = None
              ) -> list[str]:
        """The output lines of one segment, in gt's order;
        `perc_mat_history` replaces the table's (for the control)."""
        return self.walk([segment], perc_mat_history)[segment]

    def walk(self, segments, perc_mat_history: int | None = None) -> dict:
        """{segment: its output lines} of the given segments."""
        pmh = self.pmh if perc_mat_history is None else perc_mat_history
        ext = Extension(self.symbols, pmh, self.mad, self.history, self.pol)
        walks = [_Walk(self, s) for s in segments]
        while True:
            live = [w for w in walks if not w.finished]
            if not live:
                return {w.segment: w.out for w in walks}
            cands = [(w, s) for w in live for s in w.ahead(self.ROUND)]
            batch = _Round(self, ext, cands)
            for w in live:
                w.go(batch)


class _Round:
    """The extensions of one round's seeds: left flanks, then right
    flanks (whose u side ends where the left extension's v side starts,
    within one sequence), each lane run SHORT generations; the rest on
    demand (`get`)."""

    def __init__(self, plan: GreedyPlan, ext: Extension, cands: list):
        self.plan, self.ext = plan, ext
        self.index = {(id(w), s): i for i, (w, s) in enumerate(cands)}
        n = len(cands)
        k = plan.k
        self.geo = np.zeros((n, 7), np.int64)   # m, n, same, db, qs, bu, bv
        for i, (w, s) in enumerate(cands):
            self.geo[i] = (w.m, w.n, w.same, w.apos[s] + 1 - k,
                           w.bpos[s] + 1 - k, w.bu, w.bv)
        m, nv, same, db, qs, bu, bv = self.geo.T
        voff = np.where(same == 1, db + k, 0)
        self.has_left = (db > 0) & (qs > 0) & (qs - voff > 0)
        i = np.flatnonzero(self.has_left)
        self.left = results(n)
        self.left_lanes = Lanes(ext, (bu[i] + db[i] - 1, -np.ones_like(i),
                                      db[i], bv[i] + qs[i] - 1,
                                      -np.ones_like(i), qs[i] - voff[i]),
                                np.full(i.size, k), self.left, i)
        self.left_lanes.run(plan.SHORT)
        self.right = results(n)
        ready = ~self.has_left | self.left["done"]
        self.right_lanes = self._right(np.flatnonzero(ready))
        self.right_lanes.run(plan.SHORT)

    def _right(self, i: np.ndarray) -> Lanes:
        """The right flanks' lanes of candidates i (left flanks done);
        those without a right flank are done at once."""
        k = self.plan.k
        m, nv, same, db, qs, bu, bv = self.geo[i].T
        vl = np.where(self.has_left[i], self.left["alignedlen"][i] -
                      self.left["row"][i], 0)
        urb = np.where(same == 1, np.minimum(m, qs - vl), m)
        has = (db + k < urb) & (qs + k < nv)
        self.right["done"][i[~has]] = True
        j = np.flatnonzero(has)
        return Lanes(self.ext, (bu[j] + db[j] + k, np.ones_like(j),
                                urb[j] - db[j] - k, bv[j] + qs[j] + k,
                                np.ones_like(j), nv[j] - qs[j] - k),
                     np.full(j.size, k), self.right, i[j])

    def get(self, walk, s):
        """(ul, vl, dl, ur, vr, dr) of a candidate, or None where it is
        not one of this round's."""
        i = self.index.get((id(walk), s))
        if i is None:
            return None
        if self.has_left[i] and not self.left["done"][i]:
            self.left_lanes.split([i]).run()
            self._right(np.asarray([i])).run()
        elif not self.right["done"][i]:
            self.right_lanes.split([i]).run()
        L, R = self.left, self.right
        left = (L["row"][i], L["alignedlen"][i] - L["row"][i],
                L["distance"][i]) if self.has_left[i] else (0, 0, 0)
        return (*(int(x) for x in left), int(R["row"][i]),
                int(R["alignedlen"][i] - R["row"][i]),
                int(R["distance"][i]))


class _Walk:
    """GenomeTools' sequential skip / extend / accept walk over one
    segment's kept seeds (sorted by bpos, then apos)."""

    def __init__(self, plan: GreedyPlan, segment):
        aseq, bseq, strand = segment
        self.plan, self.segment, self.strand = plan, segment, strand
        self.aseq, self.bseq = aseq, bseq
        apos, bpos = plan.seeds[segment]
        self.apos, self.bpos = apos.astype(np.int64), bpos.astype(np.int64)
        self.same = int(aseq == bseq)
        self.m = plan.reads[aseq].size
        self.n = plan.reads[bseq].size
        self.bu = plan.base[(aseq, "F")]
        self.bv = plan.base[(bseq, strand)]
        k = plan.k
        # same-sequence instances that overlap are never extended
        self.overlap = (self.same == 1) & (self.apos >= self.bpos + 1 - k)
        # nor any seed but the first of those with one bpos: extending
        # a seed sets prev_b_end to its bpos or past it
        self.first = np.ones(self.bpos.size, bool)
        self.first[1:] = self.bpos[1:] != self.bpos[:-1]
        self.ptr, self.has_prev, self.prev_b_end = 0, False, -1
        self.out: list[str] = []

    @property
    def finished(self) -> bool:
        return self.ptr >= self.bpos.size

    def _skip(self) -> None:
        """Past the seeds the walk skips from its state."""
        if self.has_prev:
            self.ptr = max(self.ptr, int(np.searchsorted(
                self.bpos, self.prev_b_end, "right")))

    def ahead(self, count: int) -> np.ndarray:
        """The next `count` seeds the walk may reach from its state."""
        self._skip()
        s = np.arange(self.ptr, min(self.ptr + 4 * count, self.bpos.size))
        return s[self.first[s] & ~self.overlap[s]][:count]

    def go(self, batch: _Round) -> None:
        """Walk on until a seed that `batch` did not extend."""
        plan, k = self.plan, self.plan.k
        while True:
            self._skip()
            s = self.ptr
            if s >= self.bpos.size:
                return
            if self.overlap[s]:
                self.ptr += 1
                continue
            got = batch.get(self, s)
            if got is None:
                return
            self.has_prev = True
            self.prev_b_end, line = _verdict(
                got, k, int(self.apos[s]) + 1 - k, int(self.bpos[s]) + 1 - k,
                self.n, self.same == 1, self.aseq, self.bseq, self.strand,
                plan.errperc, plan.leastlen)
            if line is not None:
                self.out.append(line)
            self.ptr += 1


def _verdict(ext, k, db, qs, n, same, aseq, bseq, strand, errperc,
             leastlen):
    """(prev_b_end, the output line or None) of an extended seed: the
    combine modes both sides, left only, right only in order, the first
    that passes the identity and length filters reported, unless a
    same-sequence match is shown in its other orientation."""
    ul, vl, dl, ur, vr, dr = ext
    prev_b_end, line = -1, None
    for mode in range(3):
        l_ = (ul, vl, dl) if mode != 2 else (0, 0, 0)
        r_ = (ur, vr, dr) if mode != 1 else (0, 0, 0)
        dblen = k + l_[0] + r_[0]
        qlen = k + l_[1] + r_[1]
        alen = dblen + qlen
        dist = l_[2] + r_[2]
        score = alen - 3 * dist
        a_start, b_start = db - l_[0], qs - l_[1]
        if mode == 0:
            prev_b_end = b_start + qlen - 1
        err = 200.0 * dist / alen
        if err > errperc or alen < 2 * leastlen:
            continue
        b_fwd = b_start if strand == "F" else n - b_start - qlen
        if same and not (a_start < b_fwd + (strand == "P")):
            break                         # shown in its other orientation
        line = (f"{dblen} {aseq} {a_start} {strand} {qlen} {bseq} "
                f"{b_fwd} {score} {dist} {100.0 - err:.2f}")
        break
    return prev_b_end, line
