"""LTRharvest: LTR retrotransposon prediction (`gt ltrharvest`).

The port's counterpart of ``genometools_tpu/ltr/ltrharvest.py`` (ref:
src/ltr/ltrharvest_stream.c, gt_ltrharvest.c), with the reference's
phases and default parameters:

  1. seeds: exact maximal repeats of at least seedlength (30) whose two
     instances lie mindistltr..maxdistltr (1000..15000) apart on one
     sequence (ref: gt_simpleexactselfmatchstore,
     ltrharvest_stream.c:187); the index is sorted on the card
     (``build_esa``), the pairs come from the native bottom-up walk;
  2. extension: xdrop of each pair outward on both sides, scores
     (2, -2, -3, -3) (ref: gt_searchforLTRs, ltrharvest_stream.c:897);
  3. filters: LTR lengths in [minlenltr, maxlenltr] (100..1000), LTRs
     that do not overlap, similarity >= `similar` % (85), then overlap
     resolution keeping the earlier candidate;
  4. optionally the TSD (target-site duplication >= mintsd) at the
     element's boundaries.

The reference runs phases 2-3 one pair at a time on the host. Here the
filters run over all pairs at once, both extensions of every pair go
through ``ops/xdrop_batch.py::xdrop_extend_batch_pool`` in two batches
(left flanks, then right flanks; the codes are uploaded once and each
flank is an (offset, length, reversed) row against them), so they run
on K3 at quantum 4; the similarity runs once per distinct candidate
(start1, end1, start2, end2), on the scalar engine;
the TSD is searched only for the predictions that survive the overlap
resolution (it does not take part in it). ``engine="host"`` keeps the
reference's per-pair route as the oracle. Both give the reference's
predictions.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np

from ..core.encseq import Encseq
from ..device import resolve_device
from ..index.esa import build_esa
from ..match.maxpairs import enumerate_maxpairs
from ..ops.pool import upload_pool
from ..ops.xdrop import XdropScores, xdrop_extend
from ..ops.xdrop_batch import xdrop_extend_batch_pool

SCORES = XdropScores(2, -2, -3, -3)      # ref: ltrharvest arbitscores


@dataclass
class LTRPrediction:
    seqnum: int
    start1: int   # left LTR [start1, end1] inclusive, relative to seq
    end1: int
    start2: int
    end2: int
    similarity: float
    tsd_length: int = 0

    @property
    def element_range(self):
        return self.start1, self.end2


@dataclass
class LTRHarvestParams:
    seedlength: int = 30
    minlenltr: int = 100
    maxlenltr: int = 1000
    mindistltr: int = 1000
    maxdistltr: int = 15000
    similar: float = 85.0
    mintsd: int = 4
    maxtsd: int = 20
    xdropbelowscore: int = 5
    with_tsd: bool = False


def ltrharvest(encseq: Encseq, params: LTRHarvestParams | None = None,
               device="cuda", engine: str = "batch",
               trace: dict | None = None) -> list[LTRPrediction]:
    """The predictions, ordered by (seqnum, start1, end2). engine
    "batch" extends through the device batches, "host" pair by pair as
    the reference does. trace, when a dict, gains the counts and the
    seconds of each step."""
    params = params or LTRHarvestParams()
    dev = resolve_device(device)
    tr = trace if trace is not None else {}
    t0 = time.perf_counter()
    esa = build_esa(encseq, device=dev)
    t1 = time.perf_counter()
    mp = enumerate_maxpairs(esa, params.seedlength)
    t2 = time.perf_counter()
    tr.update(maxpairs=mp.count, build_esa_s=t1 - t0, maxpairs_s=t2 - t1)
    if engine == "host":
        preds = _ltrharvest_host(encseq, mp, params)
        tr["host_s"] = time.perf_counter() - t2
        return preds
    if engine != "batch":
        raise ValueError(f"unknown engine {engine!r}")
    return _ltrharvest_batch(encseq, mp, params, dev, tr)


def _ltrharvest_host(encseq: Encseq, mp, params: LTRHarvestParams
                     ) -> list[LTRPrediction]:
    """The reference's route: one pair at a time, the scalar engines."""
    preds: list[LTRPrediction] = []
    seqnum_of = encseq.seqnum_of_pos
    a = np.minimum(mp.pos1, mp.pos2).astype(np.int64)
    b = np.maximum(mp.pos1, mp.pos2).astype(np.int64)
    order = np.argsort(a, kind="stable")
    for i in order:
        p1, p2, ln = int(a[i]), int(b[i]), int(mp.length[i])
        s1, s2 = int(seqnum_of(p1)), int(seqnum_of(p2))
        if s1 != s2:
            continue
        dist = p2 - p1
        if not (params.mindistltr <= dist <= params.maxdistltr):
            continue
        lo = int(encseq.seq_startpos(s1))
        hi = int(encseq.seq_endpos(s1))
        # left extension: before both instances, read right-to-left
        ul = encseq.codes[lo:p1][::-1]
        vl = encseq.codes[p1 + ln:p2][::-1][:p1 - lo + 1]
        bl = xdrop_extend(ul, vl, params.xdropbelowscore, SCORES)
        # right extension: after both instances
        ur = encseq.codes[p1 + ln:p2]
        vr = encseq.codes[p2 + ln:hi + 1]
        br = xdrop_extend(ur, vr, params.xdropbelowscore, SCORES)
        start1 = p1 - bl.ivalue
        end1 = p1 + ln - 1 + br.ivalue
        start2 = p2 - bl.jvalue
        end2 = p2 + ln - 1 + br.jvalue
        len1 = end1 - start1 + 1
        len2 = end2 - start2 + 1
        if not (params.minlenltr <= len1 <= params.maxlenltr):
            continue
        if not (params.minlenltr <= len2 <= params.maxlenltr):
            continue
        if end1 >= start2:  # LTRs must not overlap each other
            continue
        sim = _similarity(encseq.codes[start1:end1 + 1],
                          encseq.codes[start2:end2 + 1])
        if sim < params.similar:
            continue
        pred = LTRPrediction(s1, start1 - lo, end1 - lo, start2 - lo,
                             end2 - lo, sim)
        if params.with_tsd:
            _find_tsd(encseq, pred, lo, params)
        preds.append(pred)
    return _resolve_overlaps(preds)


def _extend_side(codes, gp, u_off, u_len, v_off, v_len, rev: bool,
                 params: LTRHarvestParams, dev):
    """(ivalue, jvalue) of one side's lanes; empty flanks give (0, 0),
    as the scalar engine returns them, and skip the batch."""
    iv = np.zeros(u_off.size, np.int64)
    jv = np.zeros(u_off.size, np.int64)
    run = np.flatnonzero((u_len > 0) & (v_len > 0))
    if run.size:
        i, j, _ = xdrop_extend_batch_pool(
            codes, u_off[run], u_len[run], v_off[run], v_len[run],
            np.full(run.size, rev), params.xdropbelowscore, SCORES,
            device=dev, gp=gp)
        iv[run], jv[run] = i, j
    return iv, jv


def _ltrharvest_batch(encseq: Encseq, mp, params: LTRHarvestParams, dev,
                      tr: dict) -> list[LTRPrediction]:
    t0 = time.perf_counter()
    codes = encseq.codes
    a = np.minimum(mp.pos1, mp.pos2).astype(np.int64)
    b = np.maximum(mp.pos1, mp.pos2).astype(np.int64)
    order = np.argsort(a, kind="stable")
    a, b, ln = a[order], b[order], mp.length[order].astype(np.int64)
    s1 = encseq.seqnum_of_pos(a)
    dist = b - a
    keep = (s1 == encseq.seqnum_of_pos(b)) & \
        (params.mindistltr <= dist) & (dist <= params.maxdistltr)
    a, b, ln, s1 = a[keep], b[keep], ln[keep], s1[keep]
    lo = encseq.seq_startpos(s1).astype(np.int64)
    hi = encseq.seq_endpos(s1).astype(np.int64)
    t1 = time.perf_counter()
    gp = upload_pool(codes, dev)
    # left: codes[lo:a] and codes[a+ln:b] read backwards from their ends,
    # the second cut to its first a-lo+1 symbols (ltrharvest.py:85-86)
    inner = np.maximum(b - a - ln, 0)
    vl_len = np.minimum(inner, a - lo + 1)
    bl_i, bl_j = _extend_side(codes, gp, lo, a - lo, b - vl_len, vl_len,
                              True, params, dev)
    br_i, br_j = _extend_side(codes, gp, a + ln, inner, b + ln,
                              np.maximum(hi + 1 - b - ln, 0), False,
                              params, dev)
    t2 = time.perf_counter()
    start1, end1 = a - bl_i, a + ln - 1 + br_i
    start2, end2 = b - bl_j, b + ln - 1 + br_j
    len1, len2 = end1 - start1 + 1, end2 - start2 + 1
    ok = (params.minlenltr <= len1) & (len1 <= params.maxlenltr) & \
        (params.minlenltr <= len2) & (len2 <= params.maxlenltr) & \
        (end1 < start2)
    cand = np.stack([start1, end1, start2, end2], axis=1)[ok]
    s1, lo = s1[ok], lo[ok]
    uniq, inv = np.unique(cand, axis=0, return_inverse=True)
    t3 = time.perf_counter()
    sim = similarities(codes, uniq)[inv.reshape(-1)]
    t4 = time.perf_counter()
    hit = sim >= params.similar
    rel = cand[hit] - lo[hit, None]
    preds = [LTRPrediction(int(s), int(r[0]), int(r[1]), int(r[2]),
                           int(r[3]), float(x))
             for s, r, x in zip(s1[hit], rel, sim[hit])]
    preds = _resolve_overlaps(preds)
    if params.with_tsd:
        for p in preds:
            _find_tsd(encseq, p, int(encseq.seq_startpos(p.seqnum)), params)
    t5 = time.perf_counter()
    tr.update(pairs=int(a.size), lanes=2 * int(a.size),
              candidates=int(cand.shape[0]), distinct=int(uniq.shape[0]),
              predictions=len(preds), filters_s=(t1 - t0) + (t3 - t2),
              extensions_s=t2 - t1, similarity_s=t4 - t3,
              output_s=t5 - t4)
    return preds


def _similarity(u: np.ndarray, v: np.ndarray) -> float:
    """Percent identity of the two LTR candidates via greedy unit-cost
    distance (ref: similarity check in gt_searchforLTRs)."""
    d = untrimmed_distance(u, v)
    alignedlen = len(u) + len(v)
    if d > alignedlen:
        return 0.0
    return 100.0 * (1.0 - 2.0 * d / alignedlen)


def untrimmed_distance(u: np.ndarray, v: np.ndarray) -> int:
    """The distance ``ops/greedy.py::greedy_extend(u, v, trim=False)``
    returns, which the reference's ``_similarity`` takes: generation d's
    front takes, per diagonal, the furthest of the insertion, mismatch
    and deletion predecessors, runs along the diagonal's matches, and
    drops the cells past an end of u or v; the distance is the first
    generation whose cell on the end diagonal has consumed u (or the
    sum of the lengths). Dropping a cell can leave a diagonal empty
    between two live ones, where greedy_extend raises KeyError (in its
    polished-point update, which the distance does not read, or at the
    end diagonal); this walk skips the empty diagonal and returns the
    distance (ROADMAP, Queue 3)."""
    ulen, vlen = len(u), len(v)
    sumlen = ulen + vlen

    def run(row, k):
        vpos = row + k
        length = 0
        while row + length < ulen and vpos + length < vlen and \
                u[row + length] == v[vpos + length] and u[row + length] < 4:
            length += 1
        return row + length

    front = {0: run(0, 0)}
    lo = hi = 0
    end_k = vlen - ulen
    distance = 0
    while True:
        if distance > 0:
            new = {}
            for k in range(lo - 1, hi + 2):
                cand = front.get(k - 1)
                for src in (front.get(k), front.get(k + 1)):
                    if src is not None and (cand is None or cand < src + 1):
                        cand = src + 1
                if cand is not None:
                    new[k] = run(cand, k)
            front = new
        front = {k: r for k, r in front.items()
                 if r <= ulen and r + k <= vlen}
        lo, hi = min(front), max(front)
        if abs(end_k) <= distance and front.get(end_k) == ulen:
            return distance
        if distance >= sumlen:
            return distance
        distance += 1


def similarities(codes: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """``_similarity`` of codes[start1:end1+1] and codes[start2:end2+1]
    for each (start1, end1, start2, end2) row. The scalar walk: the
    native greedy batch without trims (``greedy_batch_native(...,
    trim=False)``) finds smaller distances on some rows, because it
    clips a cell past a sequence end where the scalar engine drops it
    (tests/test_torch_ltr.py)."""
    return np.asarray([_similarity(codes[r[0]:r[1] + 1],
                                   codes[r[2]:r[3] + 1]) for r in rows],
                      np.float64)


def _find_tsd(encseq: Encseq, pred: LTRPrediction, seqstart: int,
              params: LTRHarvestParams) -> None:
    """Search the longest exact repeat flanking the element boundaries
    (ref: gt_findcorrectboundaries / TSD search)."""
    codes = encseq.codes
    lo = seqstart
    left_end = lo + pred.start1          # exclusive end of left flank
    right_start = lo + pred.end2 + 1     # first pos after the element
    best = 0
    for tlen in range(params.maxtsd, params.mintsd - 1, -1):
        if left_end - tlen < lo:
            continue
        a = codes[left_end - tlen:left_end]
        b = codes[right_start:right_start + tlen]
        if a.size == tlen and b.size == tlen and (a == b).all() \
                and (a < 4).all():
            best = tlen
            break
    pred.tsd_length = best


def _resolve_overlaps(preds: list[LTRPrediction]) -> list[LTRPrediction]:
    """Drop candidates overlapping an already-accepted element
    (ref: ltrboundaries_overlap, ltrharvest_stream.c:1190), in the
    reference's (seqnum, start1, end2) order. The accepted elements of
    a sequence come in start1 order, so a candidate clashes with one
    iff among those with start1 <= its end2 the largest end2 reaches its
    start1: one binary search and a running maximum per candidate."""
    out: list[LTRPrediction] = []
    starts: list[int] = []
    reach: list[int] = []          # running maximum of end2
    seq = None
    for p in sorted(preds, key=lambda x: (x.seqnum, x.start1, x.end2)):
        if p.seqnum != seq:
            seq, starts, reach = p.seqnum, [], []
        k = int(np.searchsorted(starts, p.end2, side="right"))
        if k and reach[k - 1] >= p.start1:
            continue
        out.append(p)
        starts.append(p.start1)
        reach.append(max(reach[-1], p.end2) if reach else p.end2)
    return out


def fasta_out_entries(preds: list[LTRPrediction], encseq: Encseq,
                      inner: bool = False, width: int = 60):
    """FASTA lines for prediction regions (capability of
    ltrharvest_fasta_out_stream/-visitor, ref:
    src/ltr/ltrharvest_fasta_out_visitor.c): header
    '<desc> (dbseq-nr N) [start,end]' with 1-based inclusive
    coordinates; inner=True emits the between-LTR region
    (leftLTR.end+1 .. rightLTR.start-1)."""
    out = []
    for p in preds:
        if inner:
            lo1, hi1 = p.end1 + 2, p.start2        # 1-based inclusive
        else:
            lo1, hi1 = p.start1 + 1, p.end2 + 1
        if lo1 >= hi1:
            print(f"warning: trying to output empty"
                  f"{' inner' if inner else ''} sequence for candidate "
                  f"at {p.start1 + 1}-{p.end2 + 1} on sequence "
                  f"{p.seqnum}", file=sys.stderr)
            continue
        desc = encseq.descs[p.seqnum] if p.seqnum < len(encseq.descs) \
            else ""
        start = int(encseq.seq_startpos(p.seqnum))
        codes = encseq.codes[start + lo1 - 1:start + hi1]
        text = encseq.alphabet.decode(codes)
        out.append(f">{desc} (dbseq-nr {p.seqnum}) [{lo1},{hi1}]")
        for i in range(0, len(text), width):
            out.append(text[i:i + width])
    return out


def tabout_lines(preds: list[LTRPrediction], encseq: Encseq | None = None,
                 longoutput: bool = False):
    """Tabular output rows (capability of ltrharvest_tabout_visitor.c);
    longoutput adds the TSD sequence + length columns when TSDs were
    searched."""
    lines = []
    for p in preds:
        cols = [f"{p.start1} {p.end2} {p.end2 - p.start1 + 1}",
                f"{p.start1} {p.end1} {p.end1 - p.start1 + 1}"]
        if longoutput and p.tsd_length and encseq is not None:
            s = int(encseq.seq_startpos(p.seqnum))
            lt = encseq.alphabet.decode(
                encseq.codes[s + p.start1 - p.tsd_length:s + p.start1])
            rt = encseq.alphabet.decode(
                encseq.codes[s + p.end2 + 1:s + p.end2 + 1 + p.tsd_length])
            cols.append(f"{lt} {p.tsd_length}")
        cols.append(f"{p.start2} {p.end2} {p.end2 - p.start2 + 1}")
        if longoutput and p.tsd_length and encseq is not None:
            cols.append(f"{rt} {p.tsd_length}")
        cols.append(f"{p.similarity:.2f} {p.seqnum}")
        lines.append(" ".join(cols))
    return lines


def gff3_nodes(preds: list[LTRPrediction], encseq: Encseq,
               seqids: bool = False):
    """Render predictions as GFF3 feature trees like `gt ltrharvest -gff3`
    (repeat_region > LTR_retrotransposon > long_terminal_repeat x2).
    seqids=True uses the sequence description's first word as the
    region id (ref: gt_ltrharvest.c -seqids)."""
    from ..anno.genome_node import FeatureNode
    nodes = []
    for p in preds:
        seqid = f"seq{p.seqnum}"
        if seqids and p.seqnum < len(encseq.descs):
            word = encseq.descs[p.seqnum].split()
            if word:
                seqid = word[0]
        region = FeatureNode(seqid, "repeat_region",
                             p.start1 + 1 - p.tsd_length,
                             p.end2 + 1 + p.tsd_length, "?", "LTRharvest")
        elem = FeatureNode(seqid, "LTR_retrotransposon", p.start1 + 1,
                           p.end2 + 1, "?", "LTRharvest")
        region.add_child(elem)
        for s, e in ((p.start1, p.end1), (p.start2, p.end2)):
            ltr = FeatureNode(seqid, "long_terminal_repeat", s + 1, e + 1,
                              "?", "LTRharvest")
            elem.add_child(ltr)
        nodes.append(region)
    return nodes
