"""seed_extend: k-mer seeding, diagonal-band filtering and extension,
with the extensions batched through K1 and K2 (greedy) and K3 (xdrop).

Counterpart of ``genometools_tpu/match/seed_extend.py`` (ref:
src/match/diagbandseed.c:5734 gt_diagbandseed_run, seed-extend.c:994
gt_extend_sesp). The pipeline per strand: k-mer lists, seed pairs
sorted by (aseq, bseq, bpos, apos), the per-segment diagonal-band
coverage filter, then the sequential skip/extend/accept walk in
reference order. The walk runs in segment-parallel rounds over the
selected seeds' flat arrays (``_walk_rounds``): each round extends, for
every live segment at once, the next seeds its own sequential walk
would reach, in one batch; the walk then consumes them in order, so the
output equals the sequential engine's. A segment extends one seed in
each of its first two rounds and twice as many in each round after,
the speculative seeds held to twice the extensions the walk uses, or
to ROUND_MIN a round where that is more.

The device path is the path: on a CUDA device the rounds' batches run
K1, K2 and K3, on the CPU their plain versions; parameters the batches
do not take (xdrop with non-unit scores, greedy with a history outside
[30, 64]) take the host extension in the same rounds. Greedy flanks
longer than K1's windows go through the windowed chunk loop and K2
(``skip_chunked=False``), where the reference's wave path sends them
to the host engine (its match/seed_extend.py:617-625, for a cost
measured on the TPU); the lines are the same either way. The
reference's fused host C++ engine (``_native_segment_recs``) is
reachable only as ``seed_extend(..., engine="fused")``; it is the
oracle the tests and chip_smoke.py compare against. The -parts/-pick
grid runs the same pipeline per cell with either engine; -maxmat
(``maximal_exact_matches``) is the reference's host code.

Spans (``genometools_torch.trace``), per strand: seedext.seeds (k-mer
lists and seed pairs), seedext.filter (the diagonal-band filter, one
native pass over the pairs: pairs, segments kept, selected seeds, route),
seedext.order (the selected seeds' flat arrays and the
strand pool's upload), seedext.walk (the rounds; rounds, extended: seeds
sent to a batch, used: extensions the walk consumed), within it one
seedext.wave for each batch of extensions (candidates, round); in a
greedy wave, one greedy.window for each pass of the flank window (cap:
its width, lanes, retried: lanes sent on to the next, 8x wider pass).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, fields

import numpy as np

from .. import trace
from ..core.chardef import is_special
from ..core.encseq import Encseq
from ..core.native import (diagband_select_native, get_lib,
                           greedy_batch_native, kmer_list_native,
                           seed_pair_join_native, seedext_greedy_run_native,
                           xdrop_batch_native)
from ..device import resolve_device
from ..ops.greedy import PolishingInfo, greedy_extend, greedy_params_table
from ..ops.greedy_batch import greedy_extend_batch_pool
from ..ops.pool import upload_pool
from ..ops.kmer import kmer_codes_np, spaced_kmer_codes_np
from ..ops.xdrop import XdropScores, optimal_xdrop_belowscore, xdrop_extend
from ..ops.xdrop_batch import xdrop_extend_batch_pool

# the most seeds one batch of a round extends; a round with more live
# candidates goes in several batches (the seedext cell's first round
# holds 16,193, see PERF.md)
WAVE = 131072
# the fewest seeds a round may extend while its live segments have that
# many to reach: a round costs its launches and syncs whatever it holds,
# so where few segments are live (a genome's six against a read set's
# thousands) speculation up to this size is not held to twice the
# extensions used (PERF.md)
ROUND_MIN = 4096


@dataclass
class SeedExtendParams:
    seedlength: int | None = None
    minidentity: int = 80
    sensitivity: int = 97
    parts: int = 1                     # -parts grid (with pick)
    pick: tuple[int, int] | None = None
    userdefinedleastlength: int = 20   # -l
    logdiagbandwidth: int = 6
    mincoverage: int | None = None     # default 2.5 * seedlength
    maxfreq: int | None = None
    use_apos: int = 0
    forward: bool = True
    reverse: bool = True               # P strand
    no_diagband_filter: bool = False
    scores: XdropScores = field(default_factory=XdropScores)
    extension: str = "xdrop"           # "xdrop" | "greedy"
    max_combine_mode: int = 2          # BOTH / ONLY_LEFT / ONLY_RIGHT
    history: int = 64
    perc_mat_history: int | None = None
    maxalignedlendifference: int | None = None
    spacedseedweight: int | None = None   # -spacedseed (span = seedlength)

    def spaced_mask(self, k: int) -> int | None:
        """The tuned per-(span, weight) mask (ref:
        src/match/dbs_spaced_seeds.c) or None for contiguous seeds."""
        if self.spacedseedweight is None:
            return None
        from ..ops.spaced_seeds_tab import seed_for, weight_range
        w = self.spacedseedweight
        lo, hi = weight_range(k)
        if w == 0:                      # reference: weight = default
            w = max(lo, min(hi, k * 3 // 4))
        return seed_for(w, k)

    @property
    def errorpercentage(self) -> int:
        return 100 - self.minidentity

    def belowscore(self) -> int:
        return optimal_xdrop_belowscore(self.errorpercentage,
                                        self.sensitivity)

    def greedy_params(self):
        """(perc_mat_history, maxalignedlendifference) with table defaults
        (ref: seed-extend.c:405)."""
        pmh, mad = greedy_params_table(self.sensitivity,
                                       self.errorpercentage)
        if self.maxalignedlendifference is not None:
            mad = self.maxalignedlendifference
        if self.perc_mat_history is not None:
            pmh = self.perc_mat_history
        return pmh, mad

    def polishing_info(self) -> PolishingInfo:
        """The greedy polishing test of these parameters."""
        return PolishingInfo.new(float(self.errorpercentage), self.history)


def params_from_reference(p) -> SeedExtendParams:
    """The port's parameters from a reference SeedExtendParams (or any
    object carrying its fields); the xdrop scores become the port's own
    XdropScores."""
    kw = {f.name: getattr(p, f.name) for f in fields(SeedExtendParams)
          if hasattr(p, f.name)}
    if "scores" in kw:
        kw["scores"] = XdropScores(**{f.name: getattr(kw["scores"], f.name)
                                      for f in fields(XdropScores)})
    return SeedExtendParams(**kw)


@dataclass
class SeedExtendMatch:
    dblen: int
    dbseqnum: int
    dbstart: int
    direction: str
    querylen: int
    queryseqnum: int
    querystart: int
    score: int
    distance: int
    identity: float
    db_seedpos: int = 0
    query_seedpos: int = 0
    seedlen: int = 0
    mismatches: int = 0
    querystart_rc: int = 0  # on the P strand: start in revcomp coords

    def line(self) -> str:
        return (f"{self.dblen} {self.dbseqnum} {self.dbstart} "
                f"{self.direction} {self.querylen} {self.queryseqnum} "
                f"{self.querystart} {self.score} {self.distance} "
                f"{self.identity:.2f}")


def default_seedlength(aenc: Encseq, benc: Encseq, nchars: int = 4) -> int:
    """ref: gt_seed_extend.c:1032-1049."""
    avg = 0.5 * (aenc.total_length + benc.total_length)
    log_avg = int(round(math.log(max(avg, 2)) / math.log(nchars)))
    maxseqlength = max(aenc.max_seq_length(), benc.max_seq_length())
    return max(min(log_avg, maxseqlength, 32), 2)


def _revcomp_codes(enc: Encseq) -> np.ndarray:
    """Whole-encseq code array with every sequence reverse-complemented
    in place (separators untouched). Cached per encseq."""
    cached = enc.__dict__.get("_rc_codes")
    if cached is not None:
        return cached
    comp = enc.alphabet.complement_table()
    out = np.array(enc.codes, copy=True)
    for s in range(enc.num_sequences):
        lo = int(enc.seq_startpos(s))
        hi = int(enc.seq_endpos(s))
        seg = out[lo:hi + 1][::-1]
        out[lo:hi + 1] = np.where(is_special(seg), seg, comp[seg])
    enc.__dict__["_rc_codes"] = out
    return out


def _seq_codes(enc: Encseq, s: int, revcomp: bool) -> np.ndarray:
    lo = int(enc.seq_startpos(s))
    hi = int(enc.seq_endpos(s))
    seq = enc.codes[lo:hi + 1]
    if revcomp:
        comp = enc.alphabet.complement_table()
        seq = np.where(is_special(seq[::-1]), seq[::-1], comp[seq[::-1]])
    return seq


def enumerate_kmers(encseq: Encseq, k: int, revcomp: bool = False,
                    spaced_mask: int | None = None):
    """(codes, seqnum, endpos) int64 of all valid k-windows, endpos
    relative to its sequence start in the strand's reading order
    (revcomp=True reads each sequence reverse-complemented)."""
    if spaced_mask is None and k <= 31 and encseq.alphabet.num_chars == 4:
        n = encseq.num_sequences
        flat = _revcomp_codes(encseq) if revcomp else encseq.codes
        starts = np.asarray([encseq.seq_startpos(s) for s in range(n)],
                            np.int64)
        lens = np.asarray(encseq.seq_length(np.arange(n)), np.int64) \
            if n else np.zeros(0, np.int64)
        res = kmer_list_native(flat, starts, lens, k)
        if res is not None:
            return res
    codes_all, seqs_all, end_all = [], [], []
    for s in range(encseq.num_sequences):
        seq = _seq_codes(encseq, s, revcomp)
        if seq.size < k:
            continue
        if spaced_mask is not None:
            code, valid = spaced_kmer_codes_np(seq, spaced_mask)
        else:
            code, valid = kmer_codes_np(seq, k)
        pos = np.nonzero(valid)[0]
        codes_all.append(code[pos])
        seqs_all.append(np.full(pos.size, s, np.int64))
        end_all.append(pos + k - 1)
    if not codes_all:
        z = np.zeros(0, np.int64)
        return z, z, z
    return (np.concatenate(codes_all), np.concatenate(seqs_all),
            np.concatenate(end_all))


def build_seed_pairs(alist, blist, selfcomp: bool, maxfreq: int | None,
                     inseqseeds: bool = True, mindist: int = 1,
                     maxdist: int | None = None):
    """Merge-join on equal codes through the reference's native join;
    returns (aseq, bseq, bpos, apos) sorted by (aseq, bseq, bpos, apos)
    (ref: gt_diagbandseed_merge, diagbandseed.c:2654). Same-sequence
    pairs need apos + mindist <= bpos <= apos + maxdist. Lists the
    native join's packed words cannot hold (32-mers, positions beyond
    2^31) take the reference package's numpy join."""
    if get_lib() is None:
        raise RuntimeError("the native seed-pair join is unavailable")
    pairs = seed_pair_join_native(alist, blist, selfcomp, maxfreq,
                                  inseqseeds, mindist, maxdist)
    if pairs is not None:
        return pairs
    return _numpy_seed_pairs(alist, blist, selfcomp, maxfreq, inseqseeds,
                             mindist, maxdist)


def _numpy_seed_pairs(alist, blist, selfcomp, maxfreq, inseqseeds,
                      mindist, maxdist):
    """The reference package's vectorised merge-join (its
    match/seed_extend.py:178-249), same output and order as the native
    join."""
    acode, aseq, apos = alist
    bcode, bseq, bpos = blist
    same = blist is alist or (acode is bcode)
    sortkey = acode if acode.itemsize <= 4 else (
        acode.astype(np.int32) if int(acode.max(initial=0)) < 2 ** 31
        else acode)
    ao = np.argsort(sortkey, kind="stable")
    acode_s = acode[ao]
    if same:
        bo, bcode_s = ao, acode_s
    else:
        bkey = bcode if bcode.itemsize <= 4 else (
            bcode.astype(np.int32) if int(bcode.max(initial=0)) < 2 ** 31
            else bcode)
        bo = np.argsort(bkey, kind="stable")
        bcode_s = bcode[bo]

    # group boundaries per code (arrays are sorted — no np.unique resort)
    astart = np.flatnonzero(
        np.concatenate([[True], acode_s[1:] != acode_s[:-1]])) \
        if acode_s.size else np.zeros(0, np.int64)
    ua = acode_s[astart]
    acount = np.diff(np.append(astart, acode_s.size))
    if same:
        bstart, ub, bcount = astart, ua, acount
    else:
        bstart = np.flatnonzero(
            np.concatenate([[True], bcode_s[1:] != bcode_s[:-1]])) \
            if bcode_s.size else np.zeros(0, np.int64)
        ub = bcode_s[bstart]
        bcount = np.diff(np.append(bstart, bcode_s.size))
    # intersect the two sorted unique lists with one searchsorted
    if same:
        ia = ib = np.arange(ua.size)
    else:
        ii = np.searchsorted(ua, ub)
        iic = np.minimum(ii, max(ua.size - 1, 0))
        m = (ii < ua.size) & (ua[iic] == ub) if ua.size else \
            np.zeros(ub.size, bool)
        ia, ib = iic[m], np.flatnonzero(m)
    an, bn = acount[ia], bcount[ib]
    if maxfreq is not None:
        keep = np.maximum(an, bn) <= maxfreq
        ia, ib, an, bn = ia[keep], ib[keep], an[keep], bn[keep]
    if selfcomp and same:
        # a singleton code group only yields its identity pair, which
        # the strand/distance rule always drops — skip them up front
        # (the bulk of the groups on low-repetition inputs)
        g = an > 1
        ia, ib, an, bn = ia[g], ib[g], an[g], bn[g]
    # cartesian products per common code
    reps = an * bn
    total = int(reps.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    grp = np.repeat(np.arange(reps.size), reps)
    within = np.arange(total) - np.repeat(np.cumsum(reps) - reps, reps)
    ai = ao[astart[ia][grp] + within // bn[grp]]
    bi = bo[bstart[ib][grp] + within % bn[grp]]
    pa_seq, pa_pos = aseq[ai], apos[ai]
    pb_seq, pb_pos = bseq[bi], bpos[bi]
    if selfcomp:
        keep = (pa_seq < pb_seq)
        if inseqseeds:
            inrange = (pa_seq == pb_seq) & (pa_pos + mindist <= pb_pos)
            if maxdist is not None:
                inrange &= pb_pos <= pa_pos + maxdist
            keep |= inrange
        pa_seq, pa_pos = pa_seq[keep], pa_pos[keep]
        pb_seq, pb_pos = pb_seq[keep], pb_pos[keep]
    order = np.lexsort((pa_pos, pb_pos, pb_seq, pa_seq))
    return pa_seq[order], pb_seq[order], pb_pos[order], pa_pos[order]


def _score2distance(score: int, alignedlen: int) -> int:
    # ref: seed-extend.c:26 gt_querymatch_score2distance
    if score >= 0:
        return (alignedlen - score) // 3
    return -((alignedlen + score) // 3)


def _extend_one_seed(useq, vseq, same_seq, dbstart_rel, querystart_rel,
                     seedlength, belowscore, scores, greedy_ctx):
    """Host extension of one seed (ref: gt_extend_sesp) for parameters
    the device batches do not take: xdrop with non-unit scores, greedy
    with a history outside [30, 64]."""
    if same_seq and dbstart_rel + seedlength - 1 >= querystart_rel:
        return None

    def extend(u, v):
        if greedy_ctx is None:
            if scores == XdropScores():
                res = xdrop_batch_native([u], [v], belowscore)
                if res is not None:
                    return int(res[0, 0]), int(res[0, 1]), int(res[0, 2]), 0
            best = xdrop_extend(u, v, belowscore, scores)
            return best.ivalue, best.jvalue, best.score, 0
        pol_info, pmh, mad, history = greedy_ctx
        res = greedy_batch_native(
            [u], [v], max_history=history, perc_mat_history=pmh,
            maxalignedlendifference=mad, seedlengths=[seedlength],
            pol=pol_info)
        if res is not None:
            al, row, dist, mm, _died, _t = res[0].tolist()
            return int(row), int(al - row), int(dist), int(mm)
        _, best = greedy_extend(
            u, v, max_history=history, perc_mat_history=pmh,
            maxalignedlendifference=mad, seedlength=seedlength,
            pol_info=pol_info)
        return (best.row, best.alignedlen - best.row, best.distance,
                best.max_mismatches)

    u_left = v_left = left_sd = left_mm = 0
    if dbstart_rel > 0 and querystart_rel > 0:
        r_voffset = dbstart_rel + seedlength if same_seq else 0
        if querystart_rel - r_voffset > 0:
            u = useq[0:dbstart_rel][::-1]
            v = vseq[r_voffset:querystart_rel][::-1]
            u_left, v_left, left_sd, left_mm = extend(u, v)
    r_urightbound = min(len(useq), querystart_rel - v_left) if same_seq \
        else len(useq)
    u_right = v_right = right_sd = right_mm = 0
    if dbstart_rel + seedlength < r_urightbound and \
            querystart_rel + seedlength < len(vseq):
        u = useq[dbstart_rel + seedlength:r_urightbound]
        v = vseq[querystart_rel + seedlength:]
        u_right, v_right, right_sd, right_mm = extend(u, v)
    return (u_left, v_left, left_sd, u_right, v_right, right_sd,
            left_mm, right_mm)


def _batch_extensions(cands, k, greedy_ctx, belowscore, pool, gp, device):
    """Speculative device-batched extension of every candidate seed:
    left flanks in one batch, then right flanks bounded by the left
    results (the reference's sequential semantics; the skip decision
    never needs a skipped seed's extension).

    cands: int64 (n, 7) rows (useq length, vseq length, same_seq,
    dbstart_rel, querystart_rel, a pool base, b pool base), none of them
    overlapping same-sequence instances; k: int64 (n,) seed lengths
    (seed_extend's are all one k, repfind's are its maximal pairs'
    lengths). Flanks travel as (offset, len)
    rows against the uploaded pool. Greedy flanks are clipped to a
    window (whole chromosomes would otherwise ship megabases per task):
    a lane whose best point stays clear of the clip edge is exact, the
    rest retry with an 8x window. Returns int64 (n, 8) rows (u_left,
    v_left, left, u_right, v_right, right, mm_left, mm_right)."""
    ulen, vlen, same, db, qs, ga, gb = cands.T
    same = same != 0
    out = np.zeros((cands.shape[0], 8), np.int64)
    if greedy_ctx is not None:
        pol, pmh, mad, history = greedy_ctx
    CAP0 = 2048

    def run_side(lanes, maxflank, offsets, rev_side):
        """(row, vext, dist, mm) of the given lanes; offsets(cap, lanes)
        -> (u_off, u_len, v_off, v_len) pool rows (cap=None: whole
        flank)."""
        res = np.zeros((lanes.size, 4), np.int64)
        if lanes.size == 0:
            return res
        if greedy_ctx is None:
            iv, jv, sv = xdrop_extend_batch_pool(
                pool, *offsets(None, lanes), np.full(lanes.size, rev_side),
                belowscore, device=device, gp=gp)
            res[:, 0], res[:, 1], res[:, 2] = iv, jv, sv
            return res
        pending = np.arange(lanes.size)
        cap = CAP0
        while pending.size:
            with trace.span("greedy.window", cap=cap,
                            lanes=int(pending.size)) as sp:
                offs = offsets(cap, lanes[pending])
                rev = np.full(pending.size, rev_side)
                kl = k[lanes[pending]]
                slack = mad + history + kl
                # skip_chunked=False: flanks longer than K1's windows run
                # through the chunk loop and K2 (the reference's wave
                # path skips that route for a TPU-only cost; see
                # ops/greedy_batch)
                r = greedy_extend_batch_pool(
                    pool, *offs, rev, seedlengths=kl, perc_mat_history=pmh,
                    maxalignedlendifference=mad, pol_info=pol,
                    history=history, device=device, gp=gp,
                    skip_chunked=False)
                al, row = r["alignedlen"].astype(np.int64), r["row"]
                dist, mm, touched = (r["distance"], r["mismatches"],
                                     r["touched"])
                retry = (maxflank[pending] > cap) & \
                    ((al >= 2 * cap - slack) | touched)
                sp.set(retried=int(retry.sum()))
            fin = ~retry
            res[pending[fin]] = np.stack(
                [row[fin], al[fin] - row[fin], dist[fin], mm[fin]], axis=1)
            pending = pending[retry]
            cap *= 8
        return res

    def left_offsets(cap, t):
        ulo = np.zeros_like(t) if cap is None else np.maximum(0, db[t] - cap)
        vlo = voff[t] if cap is None else np.maximum(voff[t], qs[t] - cap)
        return ga[t] + ulo, db[t] - ulo, gb[t] + vlo, qs[t] - vlo

    def right_offsets(cap, t):
        dbk, qsk = db[t] + k[t], qs[t] + k[t]
        uhi = urb[t] if cap is None else np.minimum(urb[t], dbk + cap)
        vhi = vlen[t] if cap is None else np.minimum(vlen[t], qsk + cap)
        return ga[t] + dbk, uhi - dbk, gb[t] + qsk, vhi - qsk

    voff = np.where(same, db + k, 0)
    left = np.flatnonzero((db > 0) & (qs > 0) & (qs - voff > 0))
    res = run_side(left, np.maximum(db, qs - voff)[left], left_offsets,
                   True)
    out[left[:, None], [0, 1, 2, 6]] = res

    urb = np.where(same, np.minimum(ulen, qs - out[:, 1]), ulen)
    right = np.flatnonzero((db + k < urb) & (qs + k < vlen))
    res = run_side(right, np.maximum(urb - db - k, vlen - qs - k)[right],
                   right_offsets, False)
    out[right[:, None], [3, 4, 5, 7]] = res
    return out


def _depth(taken: np.ndarray, spare: int) -> np.ndarray:
    """Seeds each live segment extends in a round: one in each of its
    first two rounds (most segments need one or two extensions), then
    twice as many in each round after. The seeds past the first of each
    segment are speculative; while they would pass `spare` (twice the
    extensions the walk used so far, less those it made, or what a
    round of ROUND_MIN seeds leaves), each segment's share is cut in
    proportion, so the walk never extends more than twice the seeds it
    uses, or ROUND_MIN a round."""
    extra = np.left_shift(1, np.clip(taken - 1, 0, 20)) - 1
    total = int(extra.sum())
    if total > spare:
        extra = extra * max(spare, 0) // total
    return 1 + extra


def _ranges(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """The concatenated index ranges [lo, hi)."""
    n = np.maximum(hi - lo, 0)
    return np.repeat(lo - (np.cumsum(n) - n), n) + np.arange(int(n.sum()))


def _accept(ext, k, db, qs, vlen, same, params, direction):
    """The sequential walk's verdict on each extended seed (ref:
    gt_extend_sesp, querymatch.c:722 check_final_generic), row by row:
    the combine modes BOTH / ONLY_LEFT / ONLY_RIGHT in order, the first
    that passes the identity and length filters accepted. Returns
    (kind, prev_b_end, rect, fields): kind 1 a match, 0 a failed seed, 2
    a same-sequence match shown only in its canonical orientation (ref:
    querymatch.c:357 gt_querymatch_ordered), which is no event; mode 0
    sets prev_b_end and the rectangle (a_start, a_end, b_start, b_end);
    fields are the accepted mode's a_start, dblen, b_start, querylen,
    score, dist, mismatches and err."""
    u_l, v_l, sd_l, u_r, v_r, sd_r, mm_l, mm_r = ext.T
    zero = np.zeros_like(u_l)
    n = ext.shape[0]
    accepted = np.zeros(n, bool)
    fields = np.zeros((7, n), np.int64)
    err_out = np.zeros(n)
    for mode in range(params.max_combine_mode + 1):
        ul, vl, sl, ml = (u_l, v_l, sd_l, mm_l) if mode != 2 else (zero,) * 4
        ur, vr, sr, mr = (u_r, v_r, sd_r, mm_r) if mode != 1 else (zero,) * 4
        dblen = k + ul + ur
        querylen = k + vl + vr
        alignedlen = dblen + querylen
        if params.extension == "greedy":
            dist = sl + sr
            score = alignedlen - 3 * dist
        else:
            score = k * params.scores.mat + sl + sr
            dist = np.where(score >= 0, (alignedlen - score) // 3,
                            -((alignedlen + score) // 3))
        a_start = db - ul
        b_start = qs - vl
        if mode == 0:
            prev_b_end = b_start + querylen - 1
            rect = np.stack([a_start, a_start + dblen - 1, b_start,
                             prev_b_end])
        err = 200.0 * dist / alignedlen
        ok = ~accepted & (err <= params.errorpercentage) & \
            (alignedlen >= 2 * params.userdefinedleastlength)
        fields[:, ok] = np.stack([a_start, dblen, b_start, querylen, score,
                                  dist, ml + mr])[:, ok]
        err_out[ok] = err[ok]
        accepted |= ok
    a_start, _, b_start, querylen = fields[:4]
    b_fwd = b_start if direction == "F" else vlen - b_start - querylen
    canon = a_start < (b_fwd + 1 if direction == "P" else b_fwd)
    kind = np.where(accepted, np.where(same & ~canon, 2, 1), 0)
    return kind, prev_b_end, rect, (fields, b_fwd, err_out)


def _walk_rounds(sa, sb, sseg, g_end, same, vlen, k, params, direction,
                 extend, wave):
    """The sequential skip/extend/accept walk of every segment at once,
    in rounds. A round extends, for each live segment, the next seeds
    its walk would reach from its state at the round's start (_depth of
    them), in batches of at most `wave` through extend(seed indices) ->
    int64 (n, 8) rows; the walk then consumes them in order, and a seed
    that a new state skips was extended for nothing, which changes no
    result. Same-sequence overlapping instances the walk reaches are
    failed seeds without an extension. With use_apos 0 the seed a walk
    reaches after a row depends on that row alone, so each segment's
    rows are consumed as a chain (_consume_chains); with use_apos the
    rectangles of earlier matches decide, a step at a time.

    sa, sb, sseg: the selected seeds' apos, bpos and segment, in
    processing order (segment, then bpos and apos); g_end: each
    segment's end in them. Returns (seed, kind, fields, b_fwd, err) of
    every seed the walk reports, in processing order, and (rounds,
    extended, used)."""
    nseg = g_end.size
    use_apos = params.use_apos
    ovl = same[sseg] & (sa + k - 1 >= sb)
    has_ovl = bool(ovl.any())
    ptr = np.searchsorted(sseg, np.arange(nseg))   # the next seed to reach
    has_prev = np.zeros(nseg, bool)
    prev_b_end = np.full(nseg, -1, np.int64)
    taken = np.zeros(nseg, np.int64)
    dead = np.zeros(sa.size, bool)        # in a previous match's rectangle
    good = np.flatnonzero(~ovl)
    # with a previous match and use_apos 0, a segment reaches its first
    # seed whose bpos passes prev_b_end: one searchsorted on (segment, bpos)
    span = int(max(sb.max(initial=0), vlen.max(initial=0))) + 2
    skey = sseg * span + sb
    # (seed, kind, fields, b_fwd, err) of the seeds the walk reports
    found = [(np.zeros(0, np.int64), np.zeros(0, np.int64),
              np.zeros((7, 0), np.int64), np.zeros(0, np.int64),
              np.zeros(0))]

    def reach(g, lo):
        """The first seed each segment g reaches from lo on."""
        if use_apos != 0:
            return lo
        hp = has_prev[g]
        at = np.searchsorted(skey, g[hp] * span + prev_b_end[g[hp]], "right")
        lo = lo.copy()
        lo[hp] = np.maximum(lo[hp], at)
        return lo

    def reached_overlaps(lo, hi):
        if has_ovl:
            s = _ranges(lo, hi)
            s = s[ovl[s] & ~dead[s]]
            found.append((s, np.zeros(s.size, np.int64),
                          np.zeros((7, s.size), np.int64),
                          np.zeros(s.size, np.int64), np.zeros(s.size)))

    rounds = extended = used = 0
    live = np.flatnonzero(ptr < g_end)
    while live.size:
        if use_apos != 0:
            good = np.flatnonzero(~ovl & ~dead)
        lo = reach(live, ptr[live])
        p = np.searchsorted(good, lo)
        c = np.minimum(_depth(taken[live], max(2 * used - extended,
                                               ROUND_MIN - live.size)),
                       np.searchsorted(good, g_end[live]) - p)
        go = c > 0
        head = good[np.minimum(p, good.size - 1)] if good.size else lo
        reached_overlaps(lo, np.where(go, head, g_end[live]))
        ptr[live[~go]] = g_end[live[~go]]
        live, p, c = live[go], p[go], c[go]
        if not live.size:
            break
        rounds += 1
        taken[live] += 1
        base = np.cumsum(c) - c            # each segment's first row
        batch = good[_ranges(p, p + c)]
        exts = []
        for i in range(0, batch.size, wave):
            part = batch[i:i + wave]
            with trace.span("seedext.wave", candidates=int(part.size),
                            round=rounds):
                exts.append(extend(part))
        extended += batch.size
        g = sseg[batch]
        kind, pend, rect, info = _accept(
            np.concatenate(exts), k, sa[batch] + 1 - k, sb[batch] + 1 - k,
            vlen[g], same[g], params, direction)
        # consume the rows in each segment's walk order
        used_rows = np.zeros(batch.size, bool)
        if use_apos == 0:
            _consume_chains(batch, pend, base, p, c, live, sseg, skey, span,
                            good, used_rows, has_prev, prev_b_end, ptr,
                            reached_overlaps)
        else:
            # a match's rectangle takes the seeds in it out of the walk
            add = (use_apos == 2) | (kind > 0)
            act = np.arange(live.size)
            cur = p.copy()
            while act.size:
                gs, row = live[act], base[act] + cur[act] - p[act]
                used_rows[row] = True
                has_prev[gs] = True
                prev_b_end[gs] = pend[row]
                s = batch[row]
                if add[row].any():
                    r = row[add[row]]
                    t = _ranges(batch[r] + 1, g_end[sseg[batch[r]]])
                    a0, a1, b0, b1 = np.repeat(rect[:, r], np.maximum(
                        g_end[sseg[batch[r]]] - batch[r] - 1, 0), axis=1)
                    dead[t[(sa[t] + 1 - k <= a1) & (a0 <= sa[t]) &
                           (sb[t] + 1 - k <= b1) & (b0 <= sb[t])]] = True
                nxt = s + 1
                q = np.searchsorted(good, nxt)
                lim = p[act] + c[act]
                while True:
                    m = np.flatnonzero(q < lim)
                    m = m[dead[good[q[m]]]]
                    if not m.size:
                        break
                    q[m] += 1
                inb = q < lim
                reached_overlaps(nxt[inb], good[q[inb]])
                ptr[gs[~inb]] = nxt[~inb]
                cur[act[inb]] = q[inb]
                act = act[inb]
        used += int(used_rows.sum())
        fields, b_fwd, err = info
        found.append((batch[used_rows], kind[used_rows],
                      fields[:, used_rows], b_fwd[used_rows],
                      err[used_rows]))
        live = live[ptr[live] < g_end[live]]
    seed, kind, fields, b_fwd, err = (np.concatenate(c, axis=-1)
                                      for c in zip(*found))
    order = np.argsort(seed)
    return (seed[order], kind[order], fields[:, order], b_fwd[order],
            err[order]), (rounds, extended, used)


def _consume_chains(batch, pend, base, p, c, live, sseg, skey, span, good,
                    used_rows, has_prev, prev_b_end, ptr, reached_overlaps):
    """A round's consumption where the seed a walk reaches next depends
    on the row it extended alone (use_apos 0): the first seed past the
    row's prev_b_end. That next row is found for every row at once; each
    segment's walk is then the chain of next rows from its first, in
    which a segment with thousands of rows a round (a genome's few
    segments) costs a list lookup a row. Marks the used rows, and sets
    each segment's state and pointer from its chain's last row."""
    j = np.repeat(np.arange(live.size), c)     # each row's segment
    nxt = np.maximum(batch + 1, np.searchsorted(
        skey, sseg[batch] * span + pend, "right"))
    q = np.searchsorted(good, nxt)
    inb = q < (p + c)[j]
    following = np.where(inb, base[j] + q - p[j], -1).tolist()
    chain = []
    for r in base.tolist():
        while r >= 0:
            chain.append(r)
            r = following[r]
    rows = np.asarray(chain, np.int64)
    used_rows[rows] = True
    mid = rows[inb[rows]]
    reached_overlaps(nxt[mid], good[q[mid]])
    last = rows[~inb[rows]]                  # one a segment, in order
    gs = live[j[last]]
    has_prev[gs] = True
    prev_b_end[gs] = pend[last]
    ptr[gs] = nxt[last]


def _native_segment_recs(aenc, benc, direction, pa_seq, pb_seq, pb_pos,
                         pa_pos, k, mincov, params, selfcomp, amaxlen):
    """The reference's fused host C++ engine: the whole diagband filter
    and sequential skip/extend/accept walk in one native call. Returns
    int64[n, 12] records, or None where it does not apply."""
    if params.use_apos != 0:
        return None
    if params.extension == "xdrop":
        if params.scores != XdropScores():
            return None
        engine = 1
    elif params.extension == "greedy":
        engine = 0
    else:
        return None
    pmh, mad = params.greedy_params()
    pol = params.polishing_info()
    na, nb = aenc.num_sequences, benc.num_sequences
    a_start = np.asarray([aenc.seq_startpos(s) for s in range(na)], np.int64)
    a_len = np.asarray(aenc.seq_length(np.arange(na)), np.int64)
    b_start = np.asarray([benc.seq_startpos(s) for s in range(nb)], np.int64)
    b_len = np.asarray(benc.seq_length(np.arange(nb)), np.int64)
    bflat = benc.codes if direction == "F" else _revcomp_codes(benc)
    return seedext_greedy_run_native(
        aenc.codes, bflat, a_start, a_len, b_start, b_len,
        pa_seq, pb_seq, pb_pos, pa_pos, k=k, amaxlen=amaxlen,
        logw=params.logdiagbandwidth, mincov=mincov,
        use_filter=0 if params.no_diagband_filter else 1,
        selfcomp=selfcomp, is_p=direction == "P",
        max_combine=params.max_combine_mode, history=params.history,
        pmh=pmh, mad=mad, pol=pol, errperc=params.errorpercentage,
        leastlen2=2 * params.userdefinedleastlength, engine=engine,
        belowscore=params.belowscore())


def _recs_to_matches(recs, direction, k):
    """SeedExtendMatch objects from fused-engine records."""
    matches = []
    for (dblen, aseq, astart, querylen, bseq, bsf, score, dist,
         db, qs, mm, braw) in recs.tolist():
        alignedlen = dblen + querylen
        err = 200.0 * dist / alignedlen
        matches.append(SeedExtendMatch(
            dblen, aseq, astart, direction, querylen, bseq, bsf,
            score, dist, 100.0 - err, db, qs, k, mm, braw))
    return matches


def _strand_pool(aenc, benc, direction, device, pools):
    """(pool, b offset, uploaded pool) of a strand, made and uploaded
    once (pools caches them by direction: the grid keeps both strands'
    for all its cells, a run without it one at a time): the a-side codes
    plus the b-side plane (revcomp for P); flank windows are (offset,
    len) rows against it."""
    if direction not in pools:
        if direction == "P" or benc is not aenc:
            bflat = _revcomp_codes(benc) if direction == "P" \
                else benc.codes
            pool = np.concatenate([aenc.codes, bflat])
            b_off = aenc.codes.size
        else:
            pool = aenc.codes
            b_off = 0
        pools[direction] = (pool, b_off, upload_pool(pool, device))
    return pools[direction]


def _process_seed_pairs(aenc, benc, direction, pa_seq, pb_seq, pb_pos,
                        pa_pos, k, mincov, belowscore, params, selfcomp,
                        amaxlen, events, device, wave, pools):
    n = pa_seq.size
    if n == 0:
        return []
    greedy_ctx = None
    if params.extension == "greedy":
        pmh, mad = params.greedy_params()
        greedy_ctx = (params.polishing_info(), pmh, mad, params.history)
    # ---- pass 1: diagband coverage filter, one native pass ------------
    with trace.span("seedext.filter", pairs=n) as sp:
        idx, sseg, kstart, g_end = diagband_select_native(
            pa_seq, pb_seq, pb_pos, pa_pos, k=k, amaxlen=amaxlen,
            logw=params.logdiagbandwidth, mincov=mincov,
            use_filter=not params.no_diagband_filter)
        # only segments holding a selected seed take part in the walk
        sp.set(segments=int(kstart.size), selected=int(idx.size),
               route="native")

    # ---- pass 2: the selected seeds as flat arrays -------------------
    with trace.span("seedext.order") as sp:
        sa = pa_pos[idx].astype(np.int64)
        sb = pb_pos[idx].astype(np.int64)
        aseq = pa_seq[kstart].astype(np.int64)
        bseq = pb_seq[kstart].astype(np.int64)
        same = (aseq == bseq) if selfcomp else np.zeros(kstart.size, bool)
        vlen = np.asarray(benc.seq_length(bseq), np.int64)
        device_ok = (greedy_ctx is not None and
                     30 <= params.history <= 64) or \
            (params.extension == "xdrop" and params.scores == XdropScores())
        if device_ok:
            pool, b_off, gp = _strand_pool(aenc, benc, direction, device,
                                           pools)
            ulen = np.asarray(aenc.seq_length(aseq), np.int64)
            ga = np.asarray(aenc.seq_startpos(aseq), np.int64)
            gb = b_off + np.asarray(benc.seq_startpos(bseq), np.int64)

            def extend(s):
                g = sseg[s]
                cands = np.stack([ulen[g], vlen[g], same[g], sa[s] + 1 - k,
                                  sb[s] + 1 - k, ga[g], gb[g]], axis=1)
                return _batch_extensions(cands, np.full(s.size, k, np.int64),
                                         greedy_ctx, belowscore, pool, gp,
                                         device)
        else:
            seqs: dict = {}

            def codes(enc, sq, rc):
                key = (enc is aenc, sq, rc)
                if key not in seqs:
                    seqs[key] = _seq_codes(enc, sq, rc)
                return seqs[key]

            def extend(s):
                return np.asarray([_extend_one_seed(
                    codes(aenc, int(aseq[g]), False),
                    codes(benc, int(bseq[g]), direction == "P"),
                    bool(same[g]), a + 1 - k, b + 1 - k, k, belowscore,
                    params.scores, greedy_ctx) for g, a, b in zip(
                        sseg[s].tolist(), sa[s].tolist(), sb[s].tolist())],
                    np.int64).reshape(-1, 8)
        sp.set(candidates=int(idx.size))

    # ---- pass 3: the walk in segment-parallel rounds -----------------
    with trace.span("seedext.walk", strand=direction) as sp:
        (seed, kind, fields, b_fwd, err), (rounds, extended, used) = \
            _walk_rounds(sa, sb, sseg, g_end, same, vlen, k, params,
                         direction, extend, wave)
        if events is None:
            keep = kind == 1
            seed, kind, fields = seed[keep], kind[keep], fields[:, keep]
            b_fwd, err = b_fwd[keep], err[keep]
        matches = []
        g = sseg[seed]
        for s, kd, gi, (a_start, dblen, b_start, querylen, score, dist,
                        mm), bf, er in zip(
                seed.tolist(), kind.tolist(), g.tolist(), fields.T.tolist(),
                b_fwd.tolist(), err.tolist()):
            if kd == 1:
                m = SeedExtendMatch(
                    dblen, int(aseq[gi]), a_start, direction, querylen,
                    int(bseq[gi]), bf, score, dist, 100.0 - er,
                    int(sa[s]) + 1 - k, int(sb[s]) + 1 - k, k, mm, b_start)
                matches.append(m)
                if events is not None:
                    events.append(("match", m))
            elif kd == 0 and events is not None:
                events.append(("failed", k, int(aseq[gi]), int(sa[s]) + 1 - k,
                               direction, int(bseq[gi]), int(sb[s]) + 1 - k))
        sp.set(matches=len(matches), rounds=rounds, extended=extended,
               used=used)
    return matches


def _strand_matches(aenc, benc, direction, pairs, k, mincov, belowscore,
                    params, selfcomp, amaxlen, events, dev, wave, engine,
                    pools):
    """One strand's matches from its joined seed pairs, through the
    rounds walk (engine "wave") or the fused host engine."""
    pa_seq, pb_seq, pb_pos, pa_pos = pairs
    if engine == "fused":
        if not pa_seq.size:
            return []
        recs = _native_segment_recs(aenc, benc, direction, pa_seq, pb_seq,
                                    pb_pos, pa_pos, k, mincov, params,
                                    selfcomp, amaxlen)
        if recs is None:
            raise NotImplementedError(
                "the fused engine does not take these parameters")
        return _recs_to_matches(recs, direction, k)
    return _process_seed_pairs(aenc, benc, direction, pa_seq, pb_seq,
                               pb_pos, pa_pos, k, mincov, belowscore,
                               params, selfcomp, amaxlen, events, dev,
                               wave, pools)


def run_context(aenc, benc, params, events, dev, wave=WAVE,
                engine="wave"):
    """(strands, run): what every strand and grid cell of one run shares
    (seed length, coverage, scores, device, the strand pools' cache)."""
    k = params.seedlength or default_seedlength(aenc, benc)
    mincov = params.mincoverage if params.mincoverage is not None \
        else int(2.5 * k)
    if not params.userdefinedleastlength:
        # default -l is the mincoverage (ref: gt_seed_extend.c:1139)
        params.userdefinedleastlength = mincov
    strands = (["F"] if params.forward else []) + \
        (["P"] if params.reverse else [])
    return strands, dict(k=k, mincov=mincov, belowscore=params.belowscore(),
                         params=params, amaxlen=aenc.max_seq_length(),
                         events=events, dev=dev, wave=wave, engine=engine,
                         pools={})


def seed_extend(aenc: Encseq, benc: Encseq | None = None,
                params: SeedExtendParams | None = None,
                events: list | None = None, device="cuda",
                engine: str = "wave", wave: int = WAVE
                ) -> list[SeedExtendMatch]:
    """Seed, filter and extend; returns the matches in output order.

    engine="wave" (the path) extends through K1/K3 on `device`;
    engine="fused" runs the reference's fused host C++ engine instead
    (the oracle). events, when a list, receives ('match', m) and
    ('failed', ...) records in seed processing order. params.parts > 1
    or params.pick runs the part x part grid."""
    params = params or SeedExtendParams()
    if engine not in ("wave", "fused"):
        raise ValueError(f"unknown engine {engine!r}")
    dev = resolve_device(device) if engine == "wave" else None
    selfcomp = benc is None
    benc = benc or aenc
    strands, run = run_context(aenc, benc, params, events, dev, wave,
                               engine)
    if params.parts > 1 or params.pick:
        return _seed_extend_grid(aenc, benc, selfcomp, strands, run)
    k = run["k"]
    smask = params.spaced_mask(k)
    alist = None
    matches: list[SeedExtendMatch] = []
    for direction in strands:
        with trace.span("seedext.seeds", strand=direction) as sp:
            if alist is None:
                alist = enumerate_kmers(aenc, k, revcomp=False,
                                        spaced_mask=smask)
            blist = alist if (selfcomp and direction == "F") else \
                enumerate_kmers(benc, k, revcomp=(direction == "P"),
                                spaced_mask=smask)
            pairs = build_seed_pairs(alist, blist, selfcomp, params.maxfreq,
                                     inseqseeds=True,
                                     mindist=k if direction == "F" else 0)
            sp.set(pairs=int(pairs[0].size))
        matches.extend(_strand_matches(aenc, benc, direction, pairs,
                                       selfcomp=selfcomp, **run))
        # each strand uploads its pool once; only the grid's cells share
        run["pools"].clear()
    return matches


def sequence_ranges(enc: Encseq, parts: int) -> list[tuple[int, int]]:
    """Split sequence numbers into <= parts contiguous ranges balanced
    by total length (ref: gt_sequence_parts_info_new,
    src/tools/gt_seed_extend.c:1251-1276). Returns [start, end]
    inclusive pairs."""
    n = enc.num_sequences
    parts = max(1, min(parts, n))
    lens = np.asarray(enc.seq_length(np.arange(n)), np.int64)
    cum = np.cumsum(lens)
    total = int(cum[-1])
    cuts = [0]
    for i in range(1, parts):
        b = int(np.searchsorted(cum, total * i / parts))
        if b >= n:
            b = n - 1
        if b + 1 > cuts[-1]:
            cuts.append(b + 1)
    cuts.append(n)
    return [(cuts[i], cuts[i + 1] - 1) for i in range(len(cuts) - 1)
            if cuts[i] < cuts[i + 1]]


def _filter_list(lst, lo: int, hi: int):
    code, seq, pos = lst
    m = (seq >= lo) & (seq <= hi)
    return code[m], seq[m], pos[m]


def _seed_extend_grid(aenc, benc, selfcomp, strands, run):
    """Part x part grid scheduling (ref: gt_seed_extend.c:1251,
    diagbandseed.c:6044-6050 loop): A-ranges x B-ranges, B starting at
    the A range for self-comparison; per cell the full two-strand
    pipeline runs on the range-restricted k-mer lists. Band geometry
    stays part-invariant because the diagonal-band division uses the
    GLOBAL maximum sequence length (ref comment diagbandseed.c:4594-97),
    so the match set is independent of the part count (the reference's
    own invariance bar, sorted-output equality). As in the reference
    package, the grid's k-mers are contiguous: -spacedseed does not
    reach it."""
    aranges, branges, cells = grid_cells(aenc, benc, selfcomp, run["params"])
    k = run["k"]
    matches: list[SeedExtendMatch] = []
    alist_full = enumerate_kmers(aenc, k, revcomp=False)
    blists = {d: enumerate_kmers(benc, k, revcomp=(d == "P"))
              for d in strands}
    for ai, bi in cells:
        matches.extend(grid_cell_matches(
            aenc, benc, selfcomp, strands, alist_full, blists,
            aranges[ai], branges[bi], ai == bi, run))
    return matches


def grid_cells(aenc, benc, selfcomp, params):
    """(A-ranges, B-ranges, cells): the grid's cells (ai, bi) in output
    order, B starting at the A range for self-comparison, only the
    -pick cell when one is picked."""
    aranges = sequence_ranges(aenc, params.parts)
    branges = aranges if selfcomp else sequence_ranges(benc, params.parts)
    if params.pick is not None:
        pa, pb = params.pick
        if not (1 <= pa <= len(aranges) and 1 <= pb <= len(branges)):
            raise ValueError(
                f"option -pick must not exceed {len(aranges)} "
                f"(number of parts)")
    cells = [(ai, bi) for ai in range(len(aranges))
             for bi in range(ai if selfcomp else 0, len(branges))
             if params.pick is None or (ai + 1, bi + 1) == tuple(params.pick)]
    return aranges, branges, cells


def grid_cell_matches(aenc, benc, selfcomp, strands, alist_full, blists,
                      arange, brange, diagonal, run):
    """One part x part grid cell's full two-strand pipeline (seed
    pairing, diagband filter, extension, match records). Cells are
    mutually independent (ref: src/match/diagbandseed.c:5982). An
    off-diagonal self-comparison cell joins its pairs as a
    self-comparison but extends them as a comparison of two sets, as
    the reference package does (its match/seed_extend.py:488-494)."""
    alo, ahi = arange
    blo, bhi = brange
    alist = _filter_list(alist_full, alo, ahi)
    diag_cell = selfcomp and diagonal
    k, params = run["k"], run["params"]
    out: list[SeedExtendMatch] = []
    for direction in strands:
        blist = _filter_list(blists[direction], blo, bhi)
        pairs = build_seed_pairs(
            alist, blist, diag_cell or (selfcomp and not diagonal),
            params.maxfreq, inseqseeds=diag_cell,
            mindist=k if direction == "F" else 0)
        out.extend(_strand_matches(aenc, benc, direction, pairs,
                                   selfcomp=diag_cell, **run))
    return out


def maximal_exact_matches(aenc: Encseq, benc: Encseq | None,
                          seedlength: int, minlength: int,
                          forward: bool = True, reverse: bool = True):
    """-maxmat mode: merge colinear seeds on one diagonal into maximal
    exact matches >= minlength (ref: gt_diagbandseed_segment2maxmatches,
    diagbandseed.c:3953). Returns SeedExtendMatch records with
    distance 0 / identity 100. Host code, copied from the reference
    package."""
    selfcomp = benc is None
    benc = benc or aenc
    alist = enumerate_kmers(aenc, seedlength, revcomp=False)
    out = []
    strands = (["F"] if forward else []) + (["P"] if reverse else [])
    for direction in strands:
        blist = enumerate_kmers(benc, seedlength, revcomp=(direction == "P"))
        pa_seq, pb_seq, pb_pos, pa_pos = build_seed_pairs(
            alist, blist, selfcomp, None, inseqseeds=True,
            mindist=seedlength)
        pa_pos, pb_pos = pa_pos.astype(np.int64), pb_pos.astype(np.int64)
        # group by (aseq, bseq, diagonal); seeds on one diagonal with
        # contiguous endpos runs merge into one exact match; diagonals
        # come as bpos - apos ascending (ref: diagbandseed.c
        # segment2maxmatches order)
        diag = pa_pos - pb_pos
        order = np.lexsort((pa_pos, -diag, pb_seq, pa_seq))
        pa_seq, pb_seq = pa_seq[order], pb_seq[order]
        pa_pos, pb_pos, diag = pa_pos[order], pb_pos[order], diag[order]
        n = pa_seq.size
        i = 0
        while i < n:
            j = i
            while j + 1 < n and pa_seq[j + 1] == pa_seq[i] and \
                    pb_seq[j + 1] == pb_seq[i] and \
                    diag[j + 1] == diag[i] and \
                    pa_pos[j + 1] <= pa_pos[j] + seedlength:
                j += 1
            length = int(pa_pos[j] - pa_pos[i]) + seedlength
            if length >= minlength:
                a_start = int(pa_pos[i]) + 1 - seedlength
                b_start = int(pb_pos[i]) + 1 - seedlength
                # verify + maximal-extend exact run boundaries
                useq = _seq_codes(aenc, int(pa_seq[i]), False)
                vseq = _seq_codes(benc, int(pb_seq[i]),
                                  direction == "P")
                while a_start > 0 and b_start > 0 and \
                        useq[a_start - 1] == vseq[b_start - 1] and \
                        useq[a_start - 1] < 4:
                    a_start -= 1
                    b_start -= 1
                    length += 1
                while a_start + length < len(useq) and \
                        b_start + length < len(vseq) and \
                        useq[a_start + length] == vseq[b_start + length] \
                        and useq[a_start + length] < 4:
                    length += 1
                out.append(SeedExtendMatch(
                    length, int(pa_seq[i]), a_start, direction, length,
                    int(pb_seq[i]), b_start, 2 * length, 0, 100.0))
            i = j + 1
    # dedup (several seed runs can extend to one MEM)
    seen = set()
    uniq = []
    for m in out:
        key = (m.dbseqnum, m.dbstart, m.queryseqnum, m.querystart,
               m.dblen, m.direction)
        if key not in seen:
            seen.add(key)
            uniq.append(m)
    return uniq
