"""Alignment reconstruction + display for seed_extend matches.

The port's copy of ``genometools_tpu/match/seedext_display.py``
(JAX-free host code; the port imports nothing of the reference
package).

Capability equivalent of the reference's alignment output path
(ref: src/match/querymatch-align.c seededmatch2eoplist,
ft-front-generation.c front_trace2polished_eoplist,
ft-eoplist.c gt_eoplist_format_generic): re-run the greedy extension
with a front trace on both flanks of the seed, back-trace a polished
edit-operation list, and render BLAST-style Sbjct/Query blocks.

Validated against
testdata/see-ext-at1MB-500-alignment-seed_in_algn.matches.
"""

from __future__ import annotations

import numpy as np

from ..ops.greedy import (FT_EOP_DELETION, FT_EOP_INSERTION,
                          FT_EOP_MISMATCH, PolishingInfo, greedy_extend)

WILDCARD_SHOW = "n"


def front_trace_to_ops(trace: dict, pp, pol_size: int, match_score: int,
                       difference_score: int) -> list:
    """Polished DFS traceback -> ops in END->START order; ops are
    ('M', n) match runs and ('X'|'I'|'D', 1) edits
    (ref: ft-front-generation.c front_trace2polished_eoplist)."""
    bits, lcs = trace[(pp.distance, pp.alignedlen - 2 * pp.row)]
    lastlcs = lcs
    stack = [{
        "diagonal": pp.alignedlen - 2 * pp.row,
        "distance": pp.distance,
        "trace": bits,
        "lcs": lcs,
        "scoresum": lcs * match_score,
        "lcs_sum": lcs,
        "pathlength": 0,
        "eopcode": None,
    }]
    backtracepath: dict[int, tuple] = {}
    on_polsize_suffix = True
    top = None
    while stack:
        top = stack.pop()
        if on_polsize_suffix and \
                top["lcs_sum"] + top["pathlength"] >= pol_size:
            on_polsize_suffix = False
        if top["pathlength"] > 0:
            backtracepath[top["pathlength"] - 1] = (top["eopcode"],
                                                    top["lcs"])
        if top["trace"] == 0:
            break

        def push(eopcode, diagonal):
            cbits, clcs = trace[(top["distance"] - 1, diagonal)]
            stack.append({
                "diagonal": diagonal,
                "distance": top["distance"] - 1,
                "trace": cbits,
                "lcs": clcs,
                "scoresum": top["scoresum"] - difference_score +
                clcs * match_score,
                "lcs_sum": top["lcs_sum"] + clcs,
                "pathlength": top["pathlength"] + 1,
                "eopcode": eopcode,
            })

        # push order INS, DEL, MIS -> DFS explores MIS first while on
        # the polished suffix; off-suffix the FIRST eligible wins
        if (top["trace"] & FT_EOP_INSERTION) and \
                (not on_polsize_suffix or
                 top["scoresum"] >= difference_score):
            push("I", top["diagonal"] - 1)
            if not on_polsize_suffix:
                continue
        if (top["trace"] & FT_EOP_DELETION) and \
                (not on_polsize_suffix or
                 top["scoresum"] >= difference_score):
            push("D", top["diagonal"] + 1)
            if not on_polsize_suffix:
                continue
        if (top["trace"] & FT_EOP_MISMATCH) and \
                (not on_polsize_suffix or
                 top["scoresum"] >= difference_score):
            push("X", top["diagonal"])
    ops = []
    if lastlcs > 0:
        ops.append(("M", lastlcs))
    for idx in range(top["pathlength"]):
        eop, lcs = backtracepath[idx]
        ops.append((eop, 1))
        if lcs > 0:
            ops.append(("M", lcs))
    return ops


def _extend_with_trace(u: np.ndarray, v: np.ndarray, seedlength: int,
                       pol_info: PolishingInfo, perc_mat_history: int,
                       maxalignedlendifference: int,
                       greedyextension: bool = True):
    """Re-run the greedy front with trace recording, relaxing the
    trimming on died-out fronts (ref: seed-extend.c:796
    gt_align_front_prune_edist)."""
    sumlen = len(u) + len(v)
    maxiterations = 1 if greedyextension else perc_mat_history
    for iteration in range(maxiterations + 1):
        trace: dict = {}
        distance, pp = greedy_extend(
            u, v, seedlength=seedlength, pol_info=pol_info,
            perc_mat_history=perc_mat_history - iteration,
            maxalignedlendifference=maxalignedlendifference + iteration,
            trim=iteration < maxiterations, trace=trace)
        if distance < sumlen + 1:
            return pp, trace
    return pp, trace


def seeded_alignment(aseq: np.ndarray, bseq: np.ndarray,
                     astart: int, alen: int, bstart: int, blen: int,
                     aseed: int, bseed: int, seedlen: int,
                     pol_info: PolishingInfo, perc_mat_history: int,
                     maxalignedlendifference: int,
                     greedyextension: bool = False):
    # the reference display path always re-runs with
    # greedyextension=false (ref: seed-extend.c:307 comment), enabling
    # progressively relaxed trimmed retries before the no-trim fallback
    """Full-match edit operations in display (start->end) order plus
    the corrected coordinates (ref: querymatch-align.c:249
    gt_querymatchoutoptions_seededmatch2eoplist).

    aseq/bseq are whole-sequence code arrays; coordinates are relative
    to them.  Returns (ops, uoffset, ulen, voffset, vlen, useedoffset).
    """
    pol_size = 2 * pol_info.cut_depth
    # right flank
    ustart = aseed + seedlen
    vstart = bseed + seedlen
    ulen_r = astart + alen - ustart
    vlen_r = bstart + blen - vstart
    right_ops: list = []
    right_pp = None
    if ulen_r > 0 and vlen_r > 0:
        right_pp, tr = _extend_with_trace(
            aseq[ustart:ustart + ulen_r], bseq[vstart:vstart + vlen_r],
            seedlen, pol_info, perc_mat_history, maxalignedlendifference,
            greedyextension)
        right_ops = front_trace_to_ops(tr, right_pp, pol_size,
                                       pol_info.match_score,
                                       pol_info.difference_score)
    # left flank on reversed prefixes
    left_ops: list = []
    left_pp = None
    if aseed > astart and bseed > bstart:
        ulen_l = aseed - astart
        vlen_l = bseed - bstart
        left_pp, tl = _extend_with_trace(
            aseq[astart:aseed][::-1].copy(),
            bseq[bstart:bseed][::-1].copy(),
            seedlen, pol_info, perc_mat_history, maxalignedlendifference,
            greedyextension)
        left_ops = front_trace_to_ops(tl, left_pp, pol_size,
                                      pol_info.match_score,
                                      pol_info.difference_score)
    lrow = left_pp.row if left_pp else 0
    lcol = (left_pp.alignedlen - left_pp.row) if left_pp else 0
    rrow = right_pp.row if right_pp else 0
    rcol = (right_pp.alignedlen - right_pp.row) if right_pp else 0
    # left traceback (on reversed strings, end->start) already reads
    # left-to-right in original orientation; right needs reversing
    ops = left_ops + [("M", seedlen)] + right_ops[::-1]
    uoffset = aseed - lrow
    voffset = bseed - lcol
    return (ops, uoffset, seedlen + lrow + rrow, voffset,
            seedlen + lcol + rcol, lrow)


def format_alignment(ops, useq: np.ndarray, vseq: np.ndarray,
                     ustart: int, vstart: int, width: int = 60,
                     useedoffset: int = 0, seedlen: int = 0,
                     seed_in_algn: bool = False,
                     characters: str = "acgt") -> str:
    """BLAST-style Sbjct/Query block rendering
    (ref: ft-eoplist.c:830 gt_eoplist_format_generic with
    subject_first, forward, one_off = 0)."""
    import math
    ulen = len(useq)
    vlen = len(vseq)
    numwidth = 1 + int(math.log10(max(ustart + ulen - 1,
                                      vstart + vlen - 1)))
    top = []
    mid = []
    low = []
    cols = []  # (pre-column idx_u, pre-column idx_v), mirroring the
    # reference's end-position bookkeeping in show_advance
    idx_u = idx_v = 0
    for op, n in ops:
        for _ in range(n):
            if op in ("M", "X"):
                if idx_u >= ulen or idx_v >= vlen:
                    break
                cols.append((idx_u, idx_v))
                ca = int(useq[idx_u])
                cb = int(vseq[idx_v])
                is_match = ca < 4 and cb < 4 and ca == cb
                cc_a = characters[ca] if ca < 4 else WILDCARD_SHOW
                cc_b = characters[cb] if cb < 4 else WILDCARD_SHOW
                top.append(cc_a)
                low.append(cc_b)
                if is_match:
                    if seed_in_algn and \
                            useedoffset <= idx_u < useedoffset + seedlen:
                        mid.append("+")
                    else:
                        mid.append("|")
                else:
                    mid.append(" ")
                idx_u += 1
                idx_v += 1
            elif op == "D":
                if idx_u >= ulen:
                    break
                cols.append((idx_u, idx_v))
                ca = int(useq[idx_u])
                top.append(characters[ca] if ca < 4 else WILDCARD_SHOW)
                mid.append(" ")
                low.append("-")
                idx_u += 1
            else:  # I
                if idx_v >= vlen:
                    break
                cols.append((idx_u, idx_v))
                cb = int(vseq[idx_v])
                top.append("-")
                mid.append(" ")
                low.append(characters[cb] if cb < 4 else WILDCARD_SHOW)
                idx_v += 1
    out = []
    total = len(top)
    pos = 0
    u_start_pos = ustart
    v_start_pos = vstart
    while pos < total:
        w = min(width, total - pos)
        ue = ustart + cols[pos + w - 1][0]
        ve = vstart + cols[pos + w - 1][1]
        out.append(f"Sbjct  {u_start_pos:<{numwidth}}  "
                   f"{''.join(top[pos:pos + w])}  {ue}")
        out.append(" " * (numwidth + 9) + "".join(mid[pos:pos + w]))
        out.append(f"Query  {v_start_pos:<{numwidth}}  "
                   f"{''.join(low[pos:pos + w])}  {ve}")
        out.append("")
        pos += w
        u_start_pos = ue + 1
        v_start_pos = ve + 1
    return "\n".join(out) + "\n" if out else ""


def ops_to_cigar(ops, distinguish: bool = False) -> str:
    """Render display-order ops as a CIGAR string
    (ref: ft-eoplist.c gt_eoplist_show_cigar /
    gt_eoplist_pretty_print); distinguish=True emits '='/'X'
    (cigarX), otherwise matches and mismatches merge into 'M'."""
    runs = []
    for op, n in ops:
        if not distinguish and op in ("M", "X"):
            sym = "M"
        elif op == "M":
            sym = "="
        else:
            sym = op
        if runs and runs[-1][0] == sym:
            runs[-1][1] += n
        else:
            runs.append([sym, n])
    return "".join(f"{n}{sym}" for sym, n in runs)


def match_extra_columns(m, aenc, benc, params, outfmt, ka=None):
    """Extra output column values for one seed_extend match
    (ref: querymatch.c gt_querymatch_pretty_print column loop)."""
    from .karlin_altschul import evalue_for_match
    from .seed_extend import _seq_codes
    cols = []
    need_cigar = any(o in ("cigar", "cigarX") for o in outfmt)
    ops = None
    if need_cigar:
        pol = PolishingInfo.new(float(params.errorpercentage),
                                params.history)
        pmh, mad = params.greedy_params()
        useq = _seq_codes(aenc, m.dbseqnum, False)
        vseq = _seq_codes(benc, m.queryseqnum, m.direction == "P")
        qstart = m.querystart if m.direction == "F" else m.querystart_rc
        ops, _, _, _, _, _ = seeded_alignment(
            useq, vseq, m.dbstart, m.dblen, qstart, m.querylen,
            m.db_seedpos, m.query_seedpos, m.seedlen, pol, pmh, mad)
    for o in outfmt:
        if o == "cigar":
            cols.append(ops_to_cigar(ops, False))
        elif o == "cigarX":
            cols.append(ops_to_cigar(ops, True))
        elif o == "evalue" or o == "bitscore":
            ev, bs = evalue_for_match(
                ka, int(benc.seq_length(m.queryseqnum)),
                m.dblen + m.querylen, m.distance, m.mismatches)
            cols.append(f"{ev:1.0e}" if o == "evalue" else f"{bs:.1f}")
        elif o == "s.seqlen":
            cols.append(str(int(aenc.seq_length(m.dbseqnum))))
        elif o == "q.seqlen":
            cols.append(str(int(benc.seq_length(m.queryseqnum))))
        elif o == "subjectid":
            cols.append(aenc.descs[m.dbseqnum].split()[0])
        elif o == "queryid":
            cols.append(benc.descs[m.queryseqnum].split()[0])
        elif o == "seed.len":
            cols.append(str(m.seedlen))
        elif o == "seed.s":
            cols.append(str(m.db_seedpos))
        elif o == "seed.q":
            cols.append(str(m.query_seedpos))
    return cols


def ops_to_trace(ops, delta: int = 50, dtrace: bool = False) -> str:
    """Trace segments: every delta consumed u-chars emit the number of
    consumed v-chars (trace) or delta minus it (dtrace)
    (ref: ft-eoplist.c:461 gt_eoplist_reader_next_segment,
    querymatch-align.c trace printing)."""
    vals = []
    au = av = 0
    for op, n in ops:
        for _ in range(n):
            if op == "D":
                au += 1
            elif op == "I":
                av += 1
            else:
                au += 1
                av += 1
            if au == delta:
                vals.append(delta - av if dtrace else av)
                au = av = 0
    if au > 0 or av > 0:
        # the reference subtracts the full delta even for the tail
        # (ref: querymatch-align.c:640 trace_delta - aligned_v)
        vals.append(delta - av if dtrace else av)
    return ",".join(str(v) for v in vals)
