"""repfind: maximal exact repeats with reference-format reporting.

The port's counterpart of ``genometools_tpu/match/repfind.py`` (ref:
src/tools/gt_repfind.c). Output lines follow the reference querymatch
format for self matches (ref: src/match/querymatch.c:431 prettyprint):

    len1 seqnum1 relpos1 F len2 seqnum2 relpos2

with the instance at the smaller absolute position printed first; R
(-r) and P (-p) for matches against the reverse and the reverse
complement.

The maximal pairs come from the native bottom-up walk
(``match/maxpairs.py``) over an ESA: the index files for the forward
pairs, the card's ``build_esa`` of seq + SEPARATOR + transformed(seq)
for -r/-p. ``repfind_extend`` extends every pair through the
seed_extend batches on `device` (K1, K2r for flanks beyond K1's windows,
K3 for xdrop); ``engine="host"`` is the reference's per-pair host route,
kept as the oracle.
"""

from __future__ import annotations

import numpy as np

from ..core.chardef import SEPARATOR, is_special
from ..core.encseq import FWD, Encseq
from ..device import resolve_device
from ..index.esa import EnhancedSuffixArray, build_esa
from ..ops.pool import upload_pool
from ..ops.xdrop import XdropScores, optimal_xdrop_belowscore
from .maxpairs import enumerate_maxpairs
from .seed_extend import (SeedExtendMatch, SeedExtendParams,
                          _batch_extensions, _extend_one_seed,
                          _score2distance, _seq_codes)


def _format_rows(encseq: Encseq, p1: np.ndarray, p2: np.ndarray,
                 length: np.ndarray, direction: str) -> np.ndarray:
    """(len, seq1, rel1, len, seq2, rel2) int rows, smaller abs pos first."""
    a = np.minimum(p1, p2).astype(np.int64)
    b = np.maximum(p1, p2).astype(np.int64)
    s1 = encseq.seqnum_of_pos(a)
    s2 = encseq.seqnum_of_pos(b)
    r1 = a - encseq.seq_startpos(s1)
    r2 = b - encseq.seq_startpos(s2)
    return np.stack([length, s1, r1, length, s2, r2], axis=1)


def repfind_self(encseq: Encseq, minlength: int,
                 esa: EnhancedSuffixArray | None = None,
                 parts_memlimit: int | None = None,
                 device="cuda") -> np.ndarray:
    """Forward self maximal repeats (gt repfind -l). Returns int rows
    (len, seq1, rel1, len, seq2, rel2).

    parts_memlimit (max suffixes resident at once) streams (suf, lcp)
    segments of the host code-range parts engine into the streaming
    walker, so the suffix table never exists whole in memory (ref model:
    -parts/-memlimit sfx-partssuf.c:172 + esa-seqread.h:27). Otherwise
    the ESA is built on `device` unless given."""
    if parts_memlimit is not None:
        from ..index.seqread import SequentialSuffixArrayReader
        from .maxpairs import enumerate_maxpairs_stream
        rd = SequentialSuffixArrayReader.from_parts(
            encseq.codes, parts_memlimit, encseq.alphabet.num_chars)
        mp = enumerate_maxpairs_stream(rd, encseq, minlength)
        return _format_rows(encseq, mp.pos1, mp.pos2, mp.length, "F")
    if esa is None:
        esa = build_esa(encseq, FWD, device=device)
    mp = enumerate_maxpairs(esa, minlength)
    return _format_rows(encseq, mp.pos1, mp.pos2, mp.length, "F")


def _repfind_transformed(encseq: Encseq, minlength: int,
                         complement: bool,
                         esa: EnhancedSuffixArray | None = None,
                         device="cuda") -> np.ndarray:
    """Matches between the sequence set and its reverse (-r) or reverse
    complement (-p), byte-ordered like the reference.

    Match *set*: concatenate seq + SEPARATOR + transformed(seq), build
    its ESA on `device` and run the forward maxpairs walk, keeping
    cross-half pairs. Each concat pair (p in half 1, q in half 2) is one
    directed iterator event of the reference's query-substring machinery
    (ref: esa-mmsearch.c:847 gt_querysubstringmatchiterator_next over
    the encseq read in GT_READMODE_{REVERSE,REVCOMPL}): the db
    occurrence is p, the query occurrence's forward image starts at
    fpos = 2n - q - (len-1), and the concat pair's left/right-maximality
    equals the event's db-left-maximality + maximal extendright length.

    Reference gating and order are then applied exactly:
      * gt_querymatch_ordered with force_order (default true,
        ref: querymatch.c:73,357): print iff dbseq < queryseq, or same
        sequence and dbrel <= querystart_fwdstrand;
      * emission order = (query unit ascending, reverse-readmode offset
        ascending, db hits in suftab order): offset o relates to the
        printed forward-strand position by o = seqlen - qrel - len.
    The suftab ranks come from `esa` (the forward index), built on
    `device` when not given.
    """
    n = encseq.total_length
    cesa = build_esa(_transformed_encseq(encseq, complement), FWD,
                     device=device)
    mp = enumerate_maxpairs(cesa, minlength)
    p1, p2, ln = mp.pos1.astype(np.int64), mp.pos2.astype(np.int64), \
        mp.length.astype(np.int64)
    lo = np.minimum(p1, p2)
    hi = np.maximum(p1, p2)
    keep = (lo < n) & (hi > n)
    db, hi, ln = lo[keep], hi[keep], ln[keep]
    fpos = 2 * n - hi - (ln - 1)

    dbseq = encseq.seqnum_of_pos(db)
    dbrel = db - encseq.seq_startpos(dbseq)
    qseq = encseq.seqnum_of_pos(fpos)
    qrel = fpos - encseq.seq_startpos(qseq)  # == querystart_fwdstrand
    keep2 = (dbseq < qseq) | ((dbseq == qseq) & (dbrel <= qrel))
    dbseq, dbrel, qseq, qrel, db, ln = (a[keep2] for a in
                                        (dbseq, dbrel, qseq, qrel, db, ln))

    if esa is None:
        esa = build_esa(encseq, FWD, device=device)
    rank = np.empty(esa.suftab.size, np.int64)
    rank[esa.suftab] = np.arange(esa.suftab.size)
    off = encseq.seq_length(qseq) - qrel - ln
    order = np.lexsort((rank[db], off, qseq))
    rows = np.stack([ln, dbseq, dbrel, ln, qseq, qrel], axis=1)
    return rows[order]


def _transformed_encseq(encseq: Encseq, complement: bool) -> Encseq:
    """seq + SEPARATOR + reverse(seq) (-r) or reverse complement (-p):
    the text whose forward maximal pairs across the separator are the
    -r/-p matches."""
    n = encseq.total_length
    tr = encseq.codes[::-1]
    if complement:
        comp = encseq.alphabet.complement_table()
        tr = np.where(is_special(tr), tr, comp[tr])
    codes = np.concatenate([encseq.codes, [SEPARATOR], tr]).astype(np.uint8)
    ssp = np.concatenate([encseq.ssp, [n],
                          2 * n - encseq.ssp[::-1]]).astype(np.int64)
    return Encseq(codes, ssp, encseq.descs + encseq.descs[::-1],
                  encseq.alphabet)


def repfind_reverse(encseq: Encseq, minlength: int,
                    esa: EnhancedSuffixArray | None = None,
                    device="cuda") -> np.ndarray:
    """Reverse matches (gt repfind -r, direction letter R): substring at
    pos1 read forward equals substring at pos2 read backward."""
    return _repfind_transformed(encseq, minlength, complement=False,
                                esa=esa, device=device)


def repfind_palindromic(encseq: Encseq, minlength: int,
                        esa: EnhancedSuffixArray | None = None,
                        device="cuda") -> np.ndarray:
    """Reverse-strand matches (gt repfind -p, direction letter P)."""
    return _repfind_transformed(encseq, minlength, complement=True,
                                esa=esa, device=device)


def repfind_extend(encseq: Encseq, minlength: int,
                   extension: str = "greedy", minidentity: int = 90,
                   maxalignedlendifference: int = 30,
                   perc_mat_history: int = 55, history: int = 64,
                   esa: EnhancedSuffixArray | None = None,
                   device="cuda", engine: str = "batch",
                   sensitivity: int = 97) -> list:
    """repfind -extendgreedy/-extendxdrop: extend every maximal pair
    (ref: gt_rf_extend_selfmatch_with_output, seed-extend.c:1457).

    Returns SeedExtendMatch records in the reference's 10-column format,
    in the pairs' order. engine="batch" extends every pair in two
    batches on `device` (left flanks, then right flanks bounded by the
    left results): the pairs are independent, so this is the
    reference's answer; it takes the parameters seed_extend's device
    route takes (greedy history in [30, 64]; xdrop's unit scores).
    engine="host" is the reference's per-pair host route. The pairs come
    from `esa`, built on `device` when not given. sensitivity sets
    xdrop's belowscore (gt repfind -extendxdrop N); greedy takes its
    pruning from perc_mat_history and maxalignedlendifference."""
    if engine not in ("batch", "host"):
        raise ValueError(f"unknown engine {engine!r}")
    if extension not in ("greedy", "xdrop"):
        raise ValueError(f"unknown extension {extension!r}")
    if esa is None:
        esa = build_esa(encseq, FWD, device=device)
    pairs = enumerate_maxpairs(esa, minlength)
    params = SeedExtendParams(
        minidentity=minidentity, extension=extension, history=history,
        perc_mat_history=perc_mat_history,
        maxalignedlendifference=maxalignedlendifference)
    errorpercentage = params.errorpercentage
    greedy_ctx = None
    belowscore = 0
    if extension == "greedy":
        greedy_ctx = (params.polishing_info(), perc_mat_history,
                      maxalignedlendifference, history)
    else:
        belowscore = optimal_xdrop_belowscore(errorpercentage,
                                              sensitivity)

    a = np.minimum(pairs.pos1, pairs.pos2).astype(np.int64)
    b = np.maximum(pairs.pos1, pairs.pos2).astype(np.int64)
    ln = pairs.length.astype(np.int64)
    s1 = encseq.seqnum_of_pos(a).astype(np.int64)
    s2 = encseq.seqnum_of_pos(b).astype(np.int64)
    st1 = encseq.seq_startpos(s1).astype(np.int64)
    st2 = encseq.seq_startpos(s2).astype(np.int64)
    r1, r2 = a - st1, b - st2
    same = s1 == s2
    if engine == "batch":
        exts = _batch_pairs(encseq, s1, s2, st1, st2, r1, r2, ln, same,
                            greedy_ctx, belowscore, history, device)
    else:
        cache: dict = {}

        def seq_of(s):
            if s not in cache:
                cache[s] = _seq_codes(encseq, s, False)
            return cache[s]
        exts = [_extend_one_seed(seq_of(int(x)), seq_of(int(y)), bool(sm),
                                 int(p), int(q), int(k), belowscore,
                                 XdropScores(), greedy_ctx)
                for x, y, sm, p, q, k in zip(s1, s2, same, r1, r2, ln)]

    out = []
    for i, ext in enumerate(exts):
        if ext is None:
            continue
        u_l, v_l, sd_l, u_r, v_r, sd_r = ext[:6]
        k = int(ln[i])
        dblen = k + u_l + u_r
        querylen = k + v_l + v_r
        alignedlen = dblen + querylen
        if extension == "greedy":
            dist = sd_l + sd_r
            score = alignedlen - 3 * dist
        else:
            score = 2 * k + sd_l + sd_r
            dist = _score2distance(score, alignedlen)
        err = 200.0 * dist / alignedlen
        if err > errorpercentage or alignedlen < 2 * minlength:
            continue
        out.append(SeedExtendMatch(
            dblen, int(s1[i]), int(r1[i]) - u_l, "F", querylen, int(s2[i]),
            int(r2[i]) - v_l, score, dist, 100.0 - err))
    return out


def _batch_pairs(encseq, s1, s2, st1, st2, r1, r2, ln, same, greedy_ctx,
                 belowscore, history, device):
    """Every pair's extension through seed_extend's batches on `device`
    (the pool is the encseq's codes, uploaded once): a list of 8-tuples,
    None where the two instances overlap in one sequence (where the
    host route returns None too)."""
    if greedy_ctx is not None and not 30 <= history <= 64:
        raise ValueError(f"the device batches take a greedy history in "
                         f"[30, 64], not {history}")
    dev = resolve_device(device)
    exts: list = [None] * int(ln.size)
    ok = np.flatnonzero(~(same & (r1 + ln - 1 >= r2)))
    if ok.size == 0:
        return exts
    lens = encseq.seq_length(np.arange(encseq.num_sequences))
    cands = np.stack([lens[s1], lens[s2], same, r1, r2, st1, st2],
                     axis=1)[ok].astype(np.int64)
    pool = encseq.codes
    res = _batch_extensions(cands, ln[ok], greedy_ctx, belowscore, pool,
                            upload_pool(pool, dev), dev)
    for i, row in zip(ok.tolist(), res.tolist()):
        exts[i] = tuple(row)
    return exts


def format_match_lines(rows: np.ndarray, direction: str = "F") -> list[str]:
    d = f" {direction} "
    return [f"{a} {b} {c}{d}{x} {y} {z}"
            for a, b, c, x, y, z in rows.tolist()]


def write_match_lines(out, rows: np.ndarray, direction: str = "F",
                      chunk: int = 1 << 17) -> None:
    """Bulk emission: the C formatter writes straight to the output fd
    when one exists (an itoa loop instead of per-row Python
    formatting); otherwise join+write in chunks. Callers must emit
    nothing else between bulk calls on the same stream (the C side
    appends through its own fd)."""
    if rows.shape[0] > (1 << 14):
        try:
            fd = out.fileno()
        except Exception:
            fd = None
        if fd is not None:
            from ..core.native import write_match_lines_native
            out.flush()
            if write_match_lines_native(rows, direction,
                                        f"/dev/fd/{fd}", True):
                return
    d = f" {direction} "
    lst = rows.tolist()
    for s in range(0, len(lst), chunk):
        out.write("\n".join(
            f"{a} {b} {c}{d}{x} {y} {z}"
            for a, b, c, x, y, z in lst[s:s + chunk]))
        out.write("\n")


def parse_result_file(path: str) -> np.ndarray:
    """Parse a reference repfind .result file into canonical rows."""
    rows = []
    dirs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            rows.append([int(parts[0]), int(parts[1]), int(parts[2]),
                         int(parts[4]), int(parts[5]), int(parts[6])])
            dirs.append(parts[3])
    return np.asarray(rows, np.int64), dirs


def canonical_sort(rows: np.ndarray) -> np.ndarray:
    if rows.size == 0:
        return rows.reshape(0, 6)
    order = np.lexsort(tuple(rows[:, i] for i in (5, 4, 2, 1, 0)))
    return rows[order]
