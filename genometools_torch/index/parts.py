"""Memory-bounded, int64-capable ESA construction in code-range parts.

The port's copy of ``genometools_tpu/index/parts.py``
(JAX-free host code; the port imports nothing of the reference
package).

The capability equivalent of the reference's ``-parts`` / ``-memlimit``
planner (ref: src/match/sfx-partssuf.c:40 GtSuftabparts, planner at
:172) and its per-part pass-B (ref: src/match/sfx-suffixer.c:1947
preparethispart): the suffix set is split by first-``PREFIXLEN``-symbol
code ranges so that no part holds more than ``max_part_suffixes``
suffixes; parts are then built one at a time, each touching only
O(part) working memory beyond the (byte-packed) sequence itself, and
the concatenated part outputs ARE the suftab.  Positions are int64
throughout (the in-memory engines of index/suffix.py stop at 2^31).

Suffix-order contract (matches gt_encseq_check_comparetwosuffixes and
index.suffix exactly): regular symbols compare by code; a special at
position p compares as key ``sigma + p`` — greater than every regular
symbol, and two specials order by position.  Hence:

  * suffixes starting with a special form the tail of the suftab,
    ordered by position ascending, followed by the sentinel (empty
    suffix at totallength);
  * regular-start suffixes are partitioned by their bit-packed
    first-``PREFIXLEN`` digits (order-preserving encoding: regular
    code c -> c+1, special -> sigma+1, past-end / after-special -> 0),
    and within a part sorted by iterative digit refinement with the
    final position tiebreak resolving equal-prefix special ties.

The per-part sorter is the reference's packed-digit design, in host
numpy with int64 positions,
refining ``DIGITS_PER_ROUND`` symbols per round until every group is a
singleton (early exit), so memory per part is a few machine words per
suffix and rounds scale with the part's max LCP.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..core.chardef import is_special

PREFIXLEN = 8          # partition depth: 4^8 = 65536 buckets for DNA
DIGITS_PER_ROUND = 10  # 3 bits * 10 digits < 2^31 (int32-packable)
CHUNK = 1 << 24        # position-scan chunk (bounds planner memory)


def _digit_bits(sigma: int) -> int:
    return max(1, (sigma + 1).bit_length())


def _packed_codes(codes: np.ndarray, start: int, stop: int, depth0: int,
                  ndig: int, sigma: int, n: int) -> np.ndarray:
    """Order-preserving packed digits [depth0, depth0+ndig) of the
    suffixes starting in [start, stop): regular c -> c+1, special ->
    sigma+1, past-end and after-first-special -> 0. int64 output."""
    m = stop - start
    pos = np.arange(start, stop, dtype=np.int64)
    bits = _digit_bits(sigma)
    acc = np.zeros(m, np.int64)
    alive = np.ones(m, bool)
    for d in range(depth0, depth0 + ndig):
        idx = pos + d
        dig = codes[np.minimum(idx, n - 1)]
        # running past the end hits the sentinel — a special at
        # position n (key sigma + n), not a smallest symbol
        spec = is_special(dig) | (idx >= n)
        val = np.where(alive,
                       np.where(spec, sigma + 1, dig.astype(np.int64) + 1),
                       0)
        acc = (acc << bits) | val
        alive &= ~spec
    return acc


@dataclass
class PartPlan:
    """Code-range parts: part i covers packed first-PREFIXLEN codes in
    [bounds[i], bounds[i+1])."""
    bounds: np.ndarray        # int64[nparts+1]
    counts: np.ndarray        # int64[nparts]
    num_regular: int
    prefixlen: int


def plan_parts(codes: np.ndarray, max_part_suffixes: int,
               sigma: int = 4) -> PartPlan:
    """Pass A + planner: chunked histogram of packed first-PREFIXLEN
    codes over regular-start suffixes, greedily split into ranges of at
    most max_part_suffixes (a single over-full bucket becomes its own
    part, like the reference planner's minimum granularity)."""
    n = codes.size
    bits = _digit_bits(sigma)
    nbuckets = 1 << (bits * PREFIXLEN)
    hist = np.zeros(nbuckets, np.int64)
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        pk = _packed_codes(codes, s, e, 0, PREFIXLEN, sigma, n)
        regular = ~is_special(codes[s:e])
        hist += np.bincount(pk[regular], minlength=nbuckets)
    num_regular = int(hist.sum())

    bounds = [0]
    counts = []
    acc = 0
    nz = np.flatnonzero(hist)
    for b in nz:
        c = int(hist[b])
        if acc and acc + c > max_part_suffixes:
            bounds.append(int(b))
            counts.append(acc)
            acc = 0
        acc += c
    bounds.append(nbuckets)
    counts.append(acc)
    return PartPlan(np.asarray(bounds, np.int64),
                    np.asarray(counts, np.int64), num_regular, PREFIXLEN)


def _sort_part(codes: np.ndarray, pos: np.ndarray, sigma: int,
               n: int) -> np.ndarray:
    """Sort the suffixes at ``pos`` (all sharing no constraint beyond
    the part's code range) by iterative packed-digit refinement with
    position tiebreak. Returns pos in suffix order."""
    m = pos.size
    if m <= 1:
        return pos
    bits = _digit_bits(sigma)
    rank = np.zeros(m, np.int64)          # dense group ids, refined
    order = np.arange(m, dtype=np.int64)
    alive = np.ones(m, bool)              # in order space: no special /
    depth = 0                             # end seen at depth < current
    max_depth = n + DIGITS_PER_ROUND
    while depth < max_depth:
        # digits for the current order's positions
        p = pos[order]
        acc = np.zeros(m, np.int64)
        for d in range(depth, depth + DIGITS_PER_ROUND):
            idx = p + d
            dig = codes[np.minimum(idx, n - 1)]
            # past-the-end == sentinel special at position n; ties
            # against real specials at the same depth resolve by the
            # position key (both keys are sigma + (p + d))
            spec = is_special(dig) | (idx >= n)
            val = np.where(alive,
                           np.where(spec, sigma + 1,
                                    dig.astype(np.int64) + 1), 0)
            acc = (acc << bits) | val
            alive &= ~spec
        # stable sort within groups by (rank, digits, position); the
        # position key only ever decides between suffixes whose digits
        # stay equal through their whole compared extent — i.e. equal
        # prefixes ending in specials at the same depth, which the
        # contract orders by position (key sigma + p)
        srt = np.lexsort((p, acc, rank))
        order = order[srt]
        alive = alive[srt]
        rank_s = rank[srt]
        acc_s = acc[srt]
        neq = np.zeros(m, bool)
        neq[1:] = (rank_s[1:] != rank_s[:-1]) | (acc_s[1:] != acc_s[:-1])
        rank = np.cumsum(neq, dtype=np.int64)
        # a group is finished when its digits ran out (hit a special /
        # the end) or it became a singleton; unfinished groups are those
        # with alive digits and >1 member
        sizes = np.bincount(rank, minlength=int(rank[-1]) + 1)
        unfinished = (sizes[rank] > 1) & alive
        if not unfinished.any():
            break
        depth += DIGITS_PER_ROUND
    return pos[order]


def iter_suftab_parts(codes: np.ndarray, max_part_suffixes: int,
                      sigma: int = 4,
                      plan: PartPlan | None = None
                      ) -> Iterator[np.ndarray]:
    """Yield the suftab as consecutive int64 segments, never holding
    more than one part's working set: regular-code parts in code order,
    then all special-start suffixes by position, then the sentinel."""
    n = codes.size
    if plan is None:
        plan = plan_parts(codes, max_part_suffixes, sigma)
    nparts = plan.counts.size
    for i in range(nparts):
        lo, hi = int(plan.bounds[i]), int(plan.bounds[i + 1])
        cnt = int(plan.counts[i])
        part_pos = np.empty(cnt, np.int64)
        got = 0
        for s in range(0, n, CHUNK):
            e = min(n, s + CHUNK)
            pk = _packed_codes(codes, s, e, 0, plan.prefixlen, sigma, n)
            sel = (~is_special(codes[s:e])) & (pk >= lo) & (pk < hi)
            hits = np.flatnonzero(sel) + s
            part_pos[got:got + hits.size] = hits
            got += hits.size
        assert got == cnt
        yield _sort_part(codes, part_pos, sigma, n)
    # special-start suffixes order by position (key sigma + p)
    spec_pos = []
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        spec_pos.append(np.flatnonzero(is_special(codes[s:e])) + s)
    tail = (np.concatenate(spec_pos) if spec_pos
            else np.zeros(0, np.int64)).astype(np.int64)
    yield tail
    yield np.asarray([n], np.int64)          # sentinel (empty suffix)


def build_suftab_parts(codes: np.ndarray, max_part_suffixes: int,
                       sigma: int = 4) -> np.ndarray:
    """Whole suftab via the parts engine (for testing / small inputs —
    real >RAM runs should consume iter_suftab_parts streamingly)."""
    return np.concatenate(
        list(iter_suftab_parts(codes, max_part_suffixes, sigma)))


# ---------------------------------------------------------------------------
# streaming full-table writer: -parts with -lcp/-bwt/-bck, all readmodes
# ---------------------------------------------------------------------------

def _pair_lcps(tcodes: np.ndarray, a: np.ndarray, b: np.ndarray,
               n: int) -> np.ndarray:
    """lcp(suffix a[i], suffix b[i]) per pair — matching stops at the
    first mismatch or special (specials compare by position, never
    equal; ref: gt_encseq_check_comparetwosuffixes)."""
    m = a.size
    l = np.zeros(m, np.int64)
    act = np.flatnonzero(np.ones(m, bool))
    STEP = 32
    steps = np.arange(STEP, dtype=np.int64)
    while act.size:
        ai = a[act, None] + l[act, None] + steps
        bi = b[act, None] + l[act, None] + steps
        ok = (ai < n) & (bi < n)
        ca = tcodes[np.minimum(ai, n - 1)]
        cb = tcodes[np.minimum(bi, n - 1)]
        match = ok & (ca == cb) & ~is_special(ca)
        run = np.argmin(match, axis=1)
        run[match.all(axis=1)] = STEP
        l[act] += run
        act = act[run == STEP]
    return l


def _nonspecial_window_starts(tcodes: np.ndarray, pl: int) -> np.ndarray:
    """bool[n+1]: position p starts a special-free window of length pl
    entirely inside the sequence (used by the reference's averagelcp
    accumulation rule, ref: sfx-lcpvalues.c:414)."""
    n = tcodes.size
    sp = is_special(tcodes)
    out = np.zeros(n + 1, bool)
    if n >= pl:
        win = ~sp[:n - pl + 1]
        for j in range(1, pl):
            win &= ~sp[j:n - pl + 1 + j]
        out[:n - pl + 1] = win
    return out


def stream_esa_parts(enc, readmode: int, indexname: str, budget: int,
                     suf: bool = True, lcp: bool = False,
                     bwt: bool = False, bck: bool = False,
                     prefixlength: int | None = None,
                     intsize: int = 64) -> int:
    """-parts/-memlimit suffixerator with the full output surface.

    Streams .suf/.lcp/.llv/.bwt one part at a time (never holding the
    whole suftab), then writes .bck and .prj — byte-identical to the
    in-memory path for every readmode and any part count (the
    reference's part-count-invariance discipline, ref:
    testsuite/gt_suffixerator_include.rb:17-57).  Returns the number of
    parts used."""
    from .esa import (LCP_OVERFLOW, _write_prj, compute_bcktab,
                      recommended_prefixlength)

    tcodes = enc.codes_view(readmode)
    n = tcodes.size
    pl = prefixlength or recommended_prefixlength(
        enc.alphabet.num_chars, enc.total_length)
    sigma = enc.alphabet.num_chars
    plan = plan_parts(tcodes, budget, sigma)
    dt = np.uint64 if intsize == 64 else np.uint32

    fsuf = open(indexname + ".suf", "wb") if suf else None
    flcp = open(indexname + ".lcp", "wb") if lcp else None
    fllv = open(indexname + ".llv", "wb") if lcp else None
    fbwt = open(indexname + ".bwt", "wb") if bwt else None

    offset = 0
    prev_last = -1                 # previous segment's final position
    longest = 0
    numoflargelcps = 0
    maxbranchdepth = 0
    lcpsum = 0
    nonspec = _nonspecial_window_starts(tcodes, pl) if lcp else None
    # live progress over suffix positions written (ref: the reference
    # suffixerator's progressbar over its part iterator,
    # src/match/sfx-suffixer.c gt_progressbar_start) + combined space
    # ledger fed with each part buffer (ref: src/core/spacepeak.c)
    from ..utils import progressbar, spacepeak
    progressbar.start(lambda: offset, n)
    try:
        for seg in iter_suftab_parts(tcodes, budget, sigma, plan=plan):
            if seg.size == 0:
                continue
            spacepeak.add(seg.nbytes)
            if fsuf is not None:
                seg.astype(dt).tofile(fsuf)
            z = np.flatnonzero(seg == 0)
            if z.size:
                longest = offset + int(z[0])
            if lcp:
                a = np.empty(seg.size, np.int64)
                a[0] = max(prev_last, 0)   # head value is overwritten
                a[1:] = seg[:-1]
                vals = _pair_lcps(tcodes, a, seg, n)
                if offset == 0:
                    vals[0] = 0    # table head: no predecessor
                small = np.minimum(vals, LCP_OVERFLOW).astype(np.uint8)
                big = np.flatnonzero(vals >= LCP_OVERFLOW)
                small[big] = LCP_OVERFLOW
                small.tofile(flcp)
                if big.size:
                    llv = np.empty((big.size, 2), dt)
                    llv[:, 0] = big + offset
                    llv[:, 1] = vals[big]
                    llv.tofile(fllv)
                    numoflargelcps += int(big.size)
                if vals.size:
                    maxbranchdepth = max(maxbranchdepth, int(vals.max()))
                lcpsum += int(vals[nonspec[seg]].sum())
            if fbwt is not None:
                prevp = seg - 1
                v = tcodes[np.clip(prevp, 0, max(n - 1, 0))] \
                    .astype(np.uint8)
                v[prevp < 0] = 254             # UNDEFBWTCHAR
                v.tofile(fbwt)
            offset += seg.size
            prev_last = int(seg[-1])
            spacepeak.free(seg.nbytes)
    finally:
        progressbar.stop()
        for f in (fsuf, flcp, fllv, fbwt):
            if f is not None:
                f.close()

    class _Carrier:
        pass

    carrier = _Carrier()
    carrier.encseq = enc
    carrier.readmode = readmode
    carrier.prefixlength = pl
    carrier.longest = longest
    carrier.suftab = np.zeros(0)     # only .size-like uses below

    if bck:
        b = compute_bcktab(carrier, pl)
        bdt = np.uint64 if enc.total_length + 1 > 0xFFFFFFFF \
            else np.uint32
        with open(indexname + ".bck", "wb") as fp:
            for arr in (b.leftborder, b.countspecialcodes, b.distpfxidx):
                if arr.size == 0:
                    continue
                raw = arr.astype(bdt).tobytes()
                if len(raw) % 8:
                    raw += b"\0" * (8 - len(raw) % 8)
                fp.write(raw)

    class _Suftab:
        size = offset
    carrier.suftab = _Suftab()
    avg = (lcpsum / offset) if (lcp and offset) else 0.0
    _write_prj(carrier, indexname, numoflargelcps, avg, maxbranchdepth,
               intsize)
    return int(plan.counts.size)
