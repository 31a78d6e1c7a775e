"""ANI / JKD estimation for gt seed_extend -estim.

The port's copy of ``genometools_tpu/match/estim.py`` (host code over
the port's ``match/seed_extend.py``; its extensions are the host route
``_extend_one_seed``, as in the reference package). Capability
equivalent of the reference's accumulate-match-values
machinery (ref: src/match/diagbandseed.c:482 GtAccumulateMatchValues,
weighted_lis_filter.c, gt_seed_extend.c:792 option implications).

-estim implies -noinseqseeds and -snd_pass: every seed segment is
processed twice — pass 0 sorted by (bpos, apos) with A as the database
side, pass 1 sorted by (apos, bpos) with the roles of A and B swapped
(ref: diagbandseed.c:4315 GT_DIAGBANDSEED_PROCESS_SEGMENT).  Accepted
extensions accumulate (sum_of_alignedlen, sum_of_distance) per
(strand, pass/pair); -delta-filter first chains the segment's matches
with the weighted-LIS filter and accumulates only the best chain.

The reference package validated it against gt's
testdata/see-ext-ani-at1MB-U8.txt,
see-ext-jkd-at1MB-U8.txt, see-ext-jkd-U8-all.txt,
see-ext-jkd-df-U8-all.txt.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.encseq import Encseq
from ..ops.greedy import PolishingInfo
from .seed_extend import (SeedExtendParams, _extend_one_seed, _seq_codes,
                          build_seed_pairs, default_seedlength,
                          enumerate_kmers)

# ref: seed-extend.c:491 bias_factor[]
_BIAS_FACTOR = (.690, .690, .690, .690, .780, .850, .900, .933, .966, 1.000)


def matchscore_bias(aenc: Encseq) -> float:
    """A/T vs G/C bias factor, adapted from E. Myers' DALIGNER
    (ref: seed-extend.c:494 gt_greedy_dna_sequence_bias_get)."""
    counts = np.bincount(aenc.codes[aenc.codes < 4], minlength=4)
    at = int(counts[0] + counts[3])
    gc = int(counts[1] + counts[2])
    if at + gc == 0:
        return 1.0
    ratio = min(at, gc) / (at + gc)
    idx = int(max(0.0, (ratio + 0.025) * 20.0 - 1.0))
    return _BIAS_FACTOR[idx]


class _Entry:
    __slots__ = ("sum_dist", "sum_alen", "wscore")

    def __init__(self):
        self.sum_dist = 0
        self.sum_alen = 0
        self.wscore = 0


def _error_rate(dist: int, alignedlen: int) -> float:
    # ref: querymatch.c:192 gt_querymatch_error_rate
    return 1.0 if alignedlen == 0 else 2.0 * dist / alignedlen


def _jukes_cantor(dist: float) -> float:
    # ref: diagbandseed.c:528 gt_jukes_cantor_correction
    if dist == 0.0:
        return 0.0
    if dist > 3.0 / 4.0:
        return 1.0
    return -3.0 / 4.0 * math.log(1.0 - 4.0 / 3.0 * dist)


def wlis_evaluate(items):
    """Exact weighted-LIS chain evaluation
    (ref: weighted_lis_filter.c:228 gt_wlis_filter_evaluate with
    chain == NULL).  items = [(s_start, s_end, q_start, q_end,
    distance)].  Returns (sum_distance, sum_alignedlen,
    chain_weighted_score) or None when items is empty.

    Mirrors the C arithmetic: weights are float32, chain scores are
    integers truncated toward zero from float32 products."""
    if not items:
        return None
    recs = []
    for (s0, s1, q0, q1, d) in items:
        alen = (s1 - s0 + 1) + (q1 - q0 + 1)
        prob_id = np.float32(alen - 2 * d) / np.float32(alen)
        w = np.float32(prob_id) * np.float32(prob_id)
        recs.append({"sp": (s0, q0), "ep": (s1, q1), "dist": d, "w": w,
                     "alen": alen})
    # sort by query start; ties by (query span * weight) descending
    # (ref: gt_alignment_link_compare)
    recs.sort(key=lambda r: (r["sp"][1],
                             -float(np.float32(r["ep"][1] - r["sp"][1])
                                    * r["w"])))
    n = len(recs)
    score = [0] * n
    diff = [0] * n
    prev = [n] * n
    for i, r in enumerate(recs):
        len0 = r["ep"][0] - r["sp"][0] + 1
        len1 = r["ep"][1] - r["sp"][1] + 1
        ln = min(len0, len1)
        score[i] = int(r["w"] * np.float32(ln))
        r["minlen"] = ln
    best, maxscore, mindiff = 0, 0, None
    for i in range(1, n):
        ri = recs[i]
        for j in range(i):
            rj = recs[j]
            d = diff[j]
            ov = [0, 0]
            for dim in range(2):
                if rj["ep"][dim] >= ri["sp"][dim]:
                    ov[dim] = rj["ep"][dim] - ri["sp"][dim] + 1
                if rj["sp"][dim] < ri["sp"][dim]:
                    d += abs(rj["ep"][dim] - ri["sp"][dim])
                else:
                    d += abs(ri["ep"][dim] - rj["sp"][dim])
            overlap = max(ov)
            sc = score[j] + int(np.float32(ri["minlen"] - overlap)
                                * ri["w"])
            if sc > score[i] or (sc == score[i] and d < diff[i]):
                score[i], diff[i], prev[i] = sc, d, j
                if sc > maxscore or (sc == maxscore and
                                     (mindiff is None or d < mindiff)):
                    maxscore, mindiff, best = sc, d, i
    sum_d = sum_a = 0
    wscore = score[best]
    i = best
    while i != n:
        sum_d += recs[i]["dist"]
        sum_a += recs[i]["alen"]
        i = prev[i]
    return sum_d, sum_a, wscore


def _estim_segment_pass(useq, vseq, upos, vpos, umaxlen, k, mincov, logw,
                        belowscore, scores, greedy_ctx, max_combine_mode,
                        errorpercentage, leastlength):
    """One processing run over a seed segment with (useq, upos) as the
    database side; (upos, vpos) must be sorted by (vpos, upos).  Returns
    accepted (u_start, u_end, v_start, v_end, dist) records
    (ref: diagbandseed.c:4145 gt_diagbandseed_extend_segment)."""
    band = (umaxlen + vpos - upos) >> logw
    nb = int(band.max()) + 2
    score = np.zeros(nb + 2, np.int64)
    lastpos = np.zeros(nb + 2, np.int64)
    for i in range(upos.size):
        d = int(band[i]) + 1
        key = int(vpos[i])
        if lastpos[d] == 0 or lastpos[d] + k <= key:
            lastpos[d] = key
            score[d] += k
        elif lastpos[d] < key:
            score[d] += key - lastpos[d]
            lastpos[d] = key
    coverage = score[band + 1] + np.maximum(score[band], score[band + 2])
    sel = coverage >= mincov

    accepted = []
    haspreviousmatch = False
    prev_v_end = -1
    for i in np.nonzero(sel)[0]:
        up, vp = int(upos[i]), int(vpos[i])
        if haspreviousmatch and prev_v_end >= vp:
            continue
        dbstart_rel = up + 1 - k
        querystart_rel = vp + 1 - k
        ext = _extend_one_seed(useq, vseq, False, dbstart_rel,
                               querystart_rel, k, belowscore, scores,
                               greedy_ctx)
        if ext is None:
            continue
        u_l, v_l, sd_l, u_r, v_r, sd_r, _mm_l, _mm_r = ext
        haspreviousmatch = True
        for mode in range(max_combine_mode + 1):
            ul, vl, sl = (u_l, v_l, sd_l) if mode != 2 else (0, 0, 0)
            ur, vr, sr = (u_r, v_r, sd_r) if mode != 1 else (0, 0, 0)
            dblen = k + ul + ur
            querylen = k + vl + vr
            alignedlen = dblen + querylen
            dist = sl + sr
            u_start = dbstart_rel - ul
            v_start = querystart_rel - vl
            if mode == 0:
                prev_v_end = v_start + querylen - 1
            # ref: querymatch.c:722 check_final_generic (no evalue
            # filter: threshold defaults to DBL_MAX without -evalue)
            if 200.0 * dist / alignedlen > errorpercentage:
                continue
            if alignedlen < 2 * leastlength:
                continue
            accepted.append((u_start, u_start + dblen - 1, v_start,
                             v_start + querylen - 1, dist))
            break
    return accepted


def seed_extend_estim(aenc: Encseq, benc: Encseq | None = None,
                      params: SeedExtendParams | None = None,
                      mode: str = "JKD", delta_filter: bool = False,
                      bias_parameters: bool = False, aname: str = "",
                      bname: str = "") -> str:
    """Run the double-pass estimation and render the ANI / JKD report
    (ref: gt_accumulate_match_values_delete output section)."""
    params = params or SeedExtendParams()
    selfcomp = benc is None
    benc = benc or aenc
    k = params.seedlength or default_seedlength(aenc, benc)
    mincov = params.mincoverage if params.mincoverage is not None \
        else int(2.5 * k)
    leastlength = params.userdefinedleastlength or mincov
    belowscore = params.belowscore()
    logw = params.logdiagbandwidth
    amaxlen = aenc.max_seq_length()
    bmaxlen = benc.max_seq_length()

    greedy_ctx = None
    if params.extension == "greedy":
        bias = matchscore_bias(aenc) if bias_parameters else 1.0
        if bias_parameters:
            # ref: gt_seed_extend.c:1191 bias-dependent parameters
            params.maxalignedlendifference = 30
            params.perc_mat_history = int(100.0 -
                                          params.errorpercentage * bias)
        pmh, mad = params.greedy_params()
        pol = PolishingInfo.new(float(params.errorpercentage),
                                params.history, matchscore_bias=bias)
        greedy_ctx = (pol, pmh, mad, params.history)

    if selfcomp:
        rows = cols = aenc.num_sequences
    else:
        rows, cols = 2, 1
    matrix = [[[_Entry() for _ in range(cols)] for _ in range(rows)]
              for _ in range(2)]

    alist = enumerate_kmers(aenc, k, revcomp=False)
    strands = []
    if params.forward:
        strands.append("F")
    if params.reverse:
        strands.append("P")
    for direction in strands:
        sidx = 0 if direction == "F" else 1
        blist = enumerate_kmers(benc, k, revcomp=(direction == "P"))
        pa_seq, pb_seq, pb_pos, pa_pos = build_seed_pairs(
            alist, blist, selfcomp, params.maxfreq, inseqseeds=False,
            mindist=k if direction == "F" else 0)
        n = pa_seq.size
        if n == 0:
            continue
        seg_break = np.zeros(n, bool)
        seg_break[0] = True
        seg_break[1:] = (pa_seq[1:] != pa_seq[:-1]) | \
            (pb_seq[1:] != pb_seq[:-1])
        seg_starts = np.flatnonzero(seg_break)
        seg_ends = np.append(seg_starts[1:], n)
        for s0, s1 in zip(seg_starts, seg_ends):
            aseq, bseq = int(pa_seq[s0]), int(pb_seq[s0])
            apos = pa_pos[s0:s1].astype(np.int64)
            bpos = pb_pos[s0:s1].astype(np.int64)
            a_fwd = _seq_codes(aenc, aseq, False)
            b_dir = _seq_codes(benc, bseq, direction == "P")
            for run in range(2):
                if selfcomp:
                    entry = matrix[sidx][aseq][bseq] if run == 0 \
                        else matrix[sidx][bseq][aseq]
                else:
                    entry = matrix[sidx][run][0]
                if run == 0:
                    acc = _estim_segment_pass(
                        a_fwd, b_dir, apos, bpos, amaxlen, k, mincov,
                        logw, belowscore, params.scores, greedy_ctx,
                        params.max_combine_mode, params.errorpercentage,
                        leastlength)
                else:
                    # role swap: B forward becomes the database side,
                    # A (readmode-transformed) the query side
                    # (ref: diagbandseed.c:4326 pass 2 + 3615 swapped
                    # extension call)
                    if direction == "P":
                        ap1 = (len(a_fwd) - 1 - apos) + k - 1
                        bp1 = (len(b_dir) - 1 - bpos) + k - 1
                        v = _seq_codes(aenc, aseq, True)
                    else:
                        ap1, bp1 = apos, bpos
                        v = a_fwd
                    u = _seq_codes(benc, bseq, False)
                    order = np.lexsort((bp1, ap1))
                    acc = _estim_segment_pass(
                        u, v, bp1[order], ap1[order], bmaxlen, k,
                        mincov, logw, belowscore, params.scores,
                        greedy_ctx, params.max_combine_mode,
                        params.errorpercentage, leastlength)
                if delta_filter:
                    res = wlis_evaluate(acc)
                    if res is not None:
                        entry.sum_dist += res[0]
                        entry.sum_alen += res[1]
                        entry.wscore = res[2]
                else:
                    for (_u0, _u1, _v0, _v1, dist) in acc:
                        alen = (_u1 - _u0 + 1) + (_v1 - _v0 + 1)
                        entry.sum_alen += alen
                        entry.sum_dist += dist
    return _render(matrix, rows, mode, selfcomp, aenc, aname, bname)


def _ani_value(e: _Entry) -> float:
    # ref: diagbandseed.c:518 gt_seed_extend_ani_evaluate
    return 100.0 * (1.0 - _error_rate(e.sum_dist, e.sum_alen)) \
        if e.sum_alen > 0 else 0.0


def _render(matrix, rows, mode, selfcomp, aenc, aname, bname) -> str:
    out = []
    ani = mode == "ANI"
    evaluate = _ani_value if ani else \
        (lambda e: _error_rate(e.sum_dist, e.sum_alen))
    if selfcomp:
        out.append(f"# pairwise {mode} values for {rows} sequences")
        for row in range(rows):
            out.append(f"{row}\t{aenc.descs[row]}")
        for row in range(rows):
            for col in range(row + 1, rows):
                vals = [evaluate(matrix[i][row][col]) for i in range(2)]
                vals += [evaluate(matrix[i][col][row]) for i in range(2)]
                if ani:
                    out.append(f"{mode} {row} {col} "
                               f"{vals[0]:.4f} {vals[1]:.4f}")
                    if vals[2] > 0.0 or vals[3] > 0.0:
                        out.append(f"{mode} {col} {row} "
                                   f"{vals[2]:.4f} {vals[3]:.4f}")
                else:
                    v12 = vals[0] if matrix[0][row][col].wscore >= \
                        matrix[1][row][col].wscore else vals[1]
                    v21 = vals[2] if matrix[0][col][row].wscore >= \
                        matrix[1][col][row].wscore else vals[3]
                    jkd = (_jukes_cantor(v12) + _jukes_cantor(v21)) / 2.0
                    out.append(f"{mode} {row} {col} {jkd:.8f}")
    else:
        vals = []
        for row in range(2):
            for i in range(2):
                vals.append(evaluate(matrix[i][row][0]))
            if ani:
                pair = (aname, bname) if row == 0 else (bname, aname)
                out.append(f"{mode} {pair[0]} {pair[1]} "
                           f"{vals[2 * row]:.4f} {vals[2 * row + 1]:.4f}")
        if not ani:
            v12 = vals[0] if matrix[0][0][0].wscore >= \
                matrix[1][0][0].wscore else vals[1]
            v21 = vals[2] if matrix[0][1][0].wscore >= \
                matrix[1][1][0].wscore else vals[3]
            jkd = (_jukes_cantor(v12) + _jukes_cantor(v21)) / 2.0
            out.append(f"{mode} {aname} {bname} {jkd:.8f}")
    return "\n".join(out) + "\n"
