"""LTRdigest: PPT and PBS annotation of LTR retrotransposons.

The port's copy of ``genometools_tpu/ltr/ltrdigest.py`` (the port
imports nothing of the reference package), with one device route: the
PBS search of one ``ltrdigest`` call, one Smith-Waterman for each
(element, strand window, tRNA) lane, runs as one batch of torch ops on
``device`` (``pbs_find_batch``, ``engine="batch"``, the default); the
reference's lane-by-lane route stays as ``engine="host"``
(``pbs_find`` over ``match/alignment.py::local_alignment``). Both
return the same hits in the same order. The PPT search stays host
numpy, as in the reference.

Capability equivalent of the reference LTRdigest feature annotators
(ref: src/ltr/ltrdigest_ppt_visitor.c, ltrdigest_pbs_visitor.c,
gt_ltrdigest.c): the polypurine tract (RR_tract + U_box) is found with
a 4-state HMM decoded around the 3' LTR start; the primer binding site
by Smith-Waterman alignment of tRNA 3' ends around the 5' LTR end.
The protein-domain (pHMM/HMMER) annotator is out of scope without
vendored HMMER.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..anno.genome_node import FeatureNode, Range
from ..core.alphabet import dna_alphabet
from ..device import resolve_device
from ..match.alignment import local_alignment
from ..utils.hmm import HMM
from ..utils.seqtools import revcomp_str

PPT_OUT, PPT_IN, PPT_UBOX, PPT_N = 0, 1, 2, 3

LTRDIGEST_TAG = "LTRdigest"


@dataclass
class LTRdigestParams:
    """Defaults mirror gt_ltrdigest.c option defaults."""

    ppt_len: tuple = (8, 30)
    ubox_len: tuple = (3, 30)
    ppt_radius: int = 30
    max_ubox_dist: int = 0
    ppt_purine_prob: float = 0.97
    ppt_pyrimidine_prob: float = 0.03
    bkg_a_prob: float = 0.25
    bkg_c_prob: float = 0.25
    bkg_g_prob: float = 0.25
    bkg_t_prob: float = 0.25
    ubox_u_prob: float = 0.91
    pbs_alilen: tuple = (11, 30)
    pbs_offsetlen: tuple = (0, 5)
    pbs_trnaoffsetlen: tuple = (0, 5)
    pbs_max_edist: int = 1
    pbs_radius: int = 30
    pbs_match: int = 5
    pbs_mismatch: int = -10
    pbs_insertion: int = -20
    pbs_deletion: int = -20


# DNA code order a=0 c=1 g=2 t=3, wildcard -> 4 ('n')
_CODE = {"a": 0, "c": 1, "g": 2, "t": 3}


def _encode5(seq: str) -> np.ndarray:
    return np.array([_CODE.get(c, 4) for c in seq.lower()], np.int64)


def _ppt_hmm(p: LTRdigestParams) -> HMM:
    """ref: ltrdigest_ppt_visitor.c:160 gt_ppt_hmm_new."""
    hmm = HMM(4, 5)
    B = hmm.B
    B[PPT_OUT, :4] = [p.bkg_a_prob, p.bkg_c_prob, p.bkg_g_prob,
                      p.bkg_t_prob]
    B[PPT_IN, :4] = [p.ppt_purine_prob / 2, p.ppt_pyrimidine_prob / 2,
                     p.ppt_purine_prob / 2, p.ppt_pyrimidine_prob / 2]
    nu = (1.0 - p.ubox_u_prob) / 3.0
    B[PPT_UBOX, :4] = [nu, nu, nu, p.ubox_u_prob]
    B[PPT_N, :4] = 0.0
    B[PPT_N, 4] = 1.0
    A = hmm.A
    A[:] = 0.0
    for i in range(4):
        for j in range(4):
            if i != j:
                A[i, j] = 0.05
        A[i, i] = 1.0 - A[i].sum()
    hmm.pi[:] = 0.25
    return hmm


@dataclass
class PPTHit:
    rng: Range            # genomic 1-based
    strand: str
    score: float
    ubox: Range | None = None


def ppt_find(element_seq: str, leftltr: Range, rightltr: Range,
             element_start: int, params: LTRdigestParams | None = None
             ) -> list[PPTHit]:
    """Find PPT candidates on both strands of one LTR element
    (ref: gt_ppt_find).  element_seq is the element's sequence;
    leftltr/rightltr are genomic 1-based LTR ranges;
    element_start is the element's genomic 1-based start."""
    params = params or LTRdigestParams()
    hmm = _ppt_hmm(params)
    seqlen = len(element_seq)
    hits: list[PPTHit] = []
    for strand, seq, ltrlen in (
            ("+", element_seq, rightltr.length),
            ("-", revcomp_str(element_seq), leftltr.length)):
        radius = min(params.ppt_radius, ltrlen - 1)
        if radius < 1:
            continue
        enc = _encode5(seq)
        off = (seqlen - 1) - (ltrlen - 1) - radius - 1
        if off < 0 or off + 2 * radius + 1 > seqlen:
            continue
        decoded = hmm.viterbi(enc[off:off + 2 * radius + 1])
        hits += _group_hits(decoded, radius, strand, leftltr, rightltr,
                            params)
    hits.sort(key=lambda h: -h.score)
    return hits


def _window_to_genomic(start: int, end: int, strand: str, radius: int,
                       leftltr: Range, rightltr: Range) -> Range:
    """ref: gt_ppt_hit_get_coords."""
    if strand == "+":
        s = rightltr.start - 2 - radius + start
        return Range(s, s + (end - start))
    e = leftltr.end + radius - start
    return Range(e - (end - start), e)


def _group_hits(decoded, radius, strand, leftltr, rightltr, params):
    """Group the decoded state sequence into candidate stretches
    (ref: ltrdigest_ppt_visitor.c:293 gt_group_hits)."""
    out = []
    potential_ubox = None
    start = 0
    for i in range(2 * radius - 1):
        if decoded[i + 1] != decoded[i] or i + 2 == 2 * radius:
            state = int(decoded[i])
            length = i - start + 1
            if state == PPT_UBOX and \
                    params.ubox_len[0] <= length <= params.ubox_len[1]:
                potential_ubox = (start, i)
            elif state == PPT_IN and \
                    params.ppt_len[0] <= length <= params.ppt_len[1]:
                r2 = radius * radius
                score = (r2 - abs(radius - i) ** 2) / r2
                ubox = None
                if potential_ubox is not None:
                    if start - potential_ubox[1] <= params.max_ubox_dist:
                        ubox = _window_to_genomic(
                            potential_ubox[0], potential_ubox[1], strand,
                            radius, leftltr, rightltr)
                    potential_ubox = None
                out.append(PPTHit(
                    _window_to_genomic(start, i, strand, radius,
                                       leftltr, rightltr),
                    strand, score, ubox))
            else:
                potential_ubox = None
            start = i + 1
    return out


@dataclass
class PBSHit:
    rng: Range            # genomic 1-based
    strand: str
    trna: str
    trna_offset: int
    offset: int
    edist: int
    score: float


def _pbs_windows(element_seq: str, leftltr: Range, rightltr: Range,
                 r: int) -> list[tuple[str, str]]:
    """The strand windows of 2r + 1 bp around the 5' LTR's end,
    "+" before "-" (ref: gt_pbs_find)."""
    windows = []
    fw_off = leftltr.length - r
    if fw_off >= 0 and fw_off + 2 * r + 1 <= len(element_seq):
        windows.append(("+", element_seq[fw_off:fw_off + 2 * r + 1]))
    rev = revcomp_str(element_seq)
    rv_off = rightltr.length - r
    if rv_off >= 0 and rv_off + 2 * r + 1 <= len(rev):
        windows.append(("-", rev[rv_off:rv_off + 2 * r + 1]))
    return windows


def _pbs_keep(edist, offset, alilen, vstart, params: LTRdigestParams):
    """pbs_find's filters, on ints or on numpy arrays of them."""
    return ((edist <= params.pbs_max_edist) &
            (params.pbs_offsetlen[0] <= offset) &
            (offset <= params.pbs_offsetlen[1]) &
            (params.pbs_alilen[0] <= alilen) &
            (alilen <= params.pbs_alilen[1]) &
            (params.pbs_trnaoffsetlen[0] <= vstart) &
            (vstart <= params.pbs_trnaoffsetlen[1]))


def _pbs_hit(strand: str, ustart: int, uend: int, vstart: int,
             edist: int, desc: str, trnalen: int, element_seq: str,
             leftltr: Range, rightltr: Range, element_start: int,
             params: LTRdigestParams) -> PBSHit | None:
    """One alignment's hit, or None where the filters drop it: the
    reference's filters and float64 score, in its expression order.
    uend is exclusive and ustart inclusive, so alilen is one longer
    than the alignment, as in the reference."""
    r = params.pbs_radius
    alilen = uend - ustart + 1
    offset = abs(r - ustart)
    if not _pbs_keep(edist, offset, alilen, vstart, params):
        return None
    penalties = 1.0 if (edist == 0 or offset == 0) \
        else float(edist * offset)
    score = (alilen * ((trnalen - vstart) / trnalen)) / penalties
    # genomic coords (ref: gt_pbs_hit_get_coords)
    if strand == "+":
        s = element_start + leftltr.length - r + ustart
        rng = Range(s, s + alilen - 1)
    else:
        e = element_start + len(element_seq) - 1 \
            - (rightltr.length - r + ustart)
        rng = Range(e - alilen + 1, e)
    return PBSHit(rng, strand, desc, vstart, offset, edist, score)


def pbs_align(window: str, trna_from3: str, params: LTRdigestParams
              ) -> tuple[int, int, int, int, int]:
    """One PBS lane on the host, as pbs_find aligns it: local_alignment
    of the window against the tRNA read from its 3' end, then the unit
    edit distance of that alignment. Returns (score, ustart, uend,
    vstart, edist), the row the batch computes for the same lane."""
    alpha = dna_alphabet()
    res = local_alignment(alpha.encode(window.encode()),
                          alpha.encode(trna_from3.encode()),
                          matchscore=params.pbs_match,
                          mismatchscore=params.pbs_mismatch,
                          gapscore=params.pbs_insertion)
    edist = 0
    ui, vi = res.ustart, res.vstart
    for op, c in res.eops:
        for _ in range(c):
            if op == "M":
                if window[ui].lower() != trna_from3[vi].lower():
                    edist += 1
                ui += 1
                vi += 1
            elif op == "D":
                edist += 1
                ui += 1
            else:
                edist += 1
                vi += 1
    return res.score, res.ustart, res.uend, res.vstart, edist


def pbs_find(element_seq: str, leftltr: Range, rightltr: Range,
             element_start: int, trna_lib: list[tuple[str, str]],
             params: LTRdigestParams | None = None) -> list[PBSHit]:
    """Smith-Waterman search of tRNA 3' ends around the 5' LTR end
    (ref: gt_pbs_find), one alignment at a time: the host route.
    trna_lib = [(description, sequence)]."""
    params = params or LTRdigestParams()
    out: list[PBSHit] = []
    windows = _pbs_windows(element_seq, leftltr, rightltr,
                           params.pbs_radius)
    for desc, trna in trna_lib:
        trna_from3 = revcomp_str(trna)
        for strand, window in windows:
            score, ustart, uend, vstart, edist = pbs_align(
                window, trna_from3, params)
            if score <= 0:
                continue
            hit = _pbs_hit(strand, ustart, uend, vstart, edist, desc,
                           len(trna), element_seq, leftltr, rightltr,
                           element_start, params)
            if hit is not None:
                out.append(hit)
    out.sort(key=lambda h: -h.score)
    return out


# device memory of one lane of the batch, beyond its score matrix: the
# row's temporaries and the scan's copies, in int32 columns
_LANE_ROWS = 12
CHUNK_BYTES = {"cuda": 4 << 30, "cpu": 256 << 20}


def _symbol_ids(s: str, ids: dict) -> np.ndarray:
    """One id per character of s; two characters share an id iff their
    lower() are equal (pbs_find's edit-distance test)."""
    cps = np.frombuffer(s.encode("utf-32-le"), "<u4")
    uniq, inv = np.unique(cps, return_inverse=True)
    m = np.asarray([ids.setdefault(chr(c).lower(), len(ids)) for c in uniq],
                   np.int32)
    return m[inv].astype(np.int32)


def _sw_lanes(u, v, vlen, ul, vl, params: LTRdigestParams, tr: dict
              ) -> torch.Tensor:
    """Smith-Waterman of C lanes at once: u (C, W) window codes, v (C, V)
    tRNA codes padded on the right, vlen (C,) their lengths, ul/vl the
    characters' lower-case ids. Returns (C, 5) int32: score, ustart,
    uend, vstart and edist as pbs_find computes them.

    The fill runs row by row: with T = max(0, diag, up) and T[0] = 0,
    S[i, j] = j g + max_{k <= j} (T[k] - k g), exact in integers. Pad
    columns lie after the real ones, so they feed no real cell; they are
    kept out of the best-cell search. The best cell is the first
    maximum in row-major order; the traceback walks all lanes in
    lockstep, diagonal before up (D) before left (I)."""
    C, W = u.shape
    V1 = v.shape[1] + 1
    dev = u.device
    ma, mm, g = params.pbs_match, params.pbs_mismatch, params.pbs_insertion
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    S = torch.zeros((C, W + 1, V1), dtype=torch.int32, device=dev)
    kg = torch.arange(V1, dtype=torch.int32, device=dev) * g
    real = torch.arange(V1, device=dev)[None, :] <= vlen[:, None]
    rowmax = torch.zeros((C, W + 1), dtype=torch.int32, device=dev)
    zero = torch.zeros((C, 1), dtype=torch.int32, device=dev)
    for i in range(1, W + 1):
        ui = u[:, i - 1:i]
        sub = torch.where((v == ui) & (ui < 4), ma, mm).to(torch.int32)
        prev = S[:, i - 1]
        t = torch.maximum(prev[:, :-1] + sub, prev[:, 1:] + g).clamp_min_(0)
        x = torch.cat([zero, t], 1) - kg
        k = 1
        while k < V1:   # running maximum along the row, in log steps
            y = x.clone()
            torch.maximum(x[:, k:], x[:, :-k], out=y[:, k:])
            x = y
            k *= 2
        row = x + kg
        S[:, i] = row
        rowmax[:, i] = torch.where(real, row, -1).amax(1)
    best = rowmax.amax(1)
    rows = torch.arange(W + 1, device=dev).expand(C, -1)
    besti = torch.where(rowmax == best[:, None], rows, W + 1).amin(1)
    lane = torch.arange(C, device=dev)
    cols = torch.arange(V1, device=dev).expand(C, -1)
    bestj = torch.where((S[lane, besti] == best[:, None]) & real, cols,
                        V1).amin(1)
    sync()
    t1 = time.perf_counter()
    i, j = besti, bestj
    edist = torch.zeros(C, dtype=torch.int32, device=dev)
    for step in range(W + V1):
        s = S[lane, i, j]
        active = (i > 0) & (j > 0) & (s > 0)
        if step % 16 == 0 and not bool(active.any()):
            break
        im, jm = (i - 1).clamp_min(0), (j - 1).clamp_min(0)
        a, b = u[lane, im], v[lane, jm]
        sub = torch.where((a == b) & (a < 4), ma, mm)
        diag = active & (s == S[lane, im, jm] + sub)
        up = active & ~diag & (s == S[lane, im, j] + g)
        left = active & ~diag & ~up
        edist += ((diag & (ul[lane, im] != vl[lane, jm])) | up | left) \
            .to(torch.int32)
        i = i - (diag | up).long()
        j = j - (diag | left).long()
    out = torch.stack([best, i.to(torch.int32), besti.to(torch.int32),
                       j.to(torch.int32), edist], 1)
    sync()
    tr["fill_s"] = tr.get("fill_s", 0.0) + t1 - t0
    tr["traceback_s"] = tr.get("traceback_s", 0.0) + \
        time.perf_counter() - t1
    return out


def pbs_find_batch(elements, trna_lib: list[tuple[str, str]],
                   params: LTRdigestParams | None = None, device="cuda",
                   trace: dict | None = None) -> list[list[PBSHit]]:
    """pbs_find for every element at once: elements = [(element_seq,
    leftltr, rightltr, element_start)] as pbs_find takes them; returns
    each element's hits as pbs_find returns them (every field, in its
    order). Each (element, strand window, tRNA) lane is one
    Smith-Waterman; the lanes run as one batch on device, in chunks whose
    int32 matrices fit CHUNK_BYTES. The filters and the score run on the
    host. trace, when a dict, gains the lane count and the seconds of the
    fill, the traceback and the host filters."""
    params = params or LTRdigestParams()
    dev = resolve_device(device)
    tr = trace if trace is not None else {}
    alpha = dna_alphabet()
    r = params.pbs_radius
    W = 2 * r + 1
    ids: dict = {}

    def codes(s: str) -> tuple[np.ndarray, np.ndarray]:
        c = alpha.encode(s.encode())
        if c.size != len(s):
            raise ValueError("the PBS batch takes ASCII sequences")
        return c.astype(np.int32), _symbol_ids(s, ids)

    wins, lane_win, lane_trna = [], [], []
    T = len(trna_lib)
    for e, (seq, lrel, rrel, _start) in enumerate(elements):
        ws = _pbs_windows(seq, lrel, rrel, r)
        # lanes in pbs_find's order: tRNA outer, then "+" before "-"
        lane_win.append(len(wins) + np.tile(np.arange(len(ws)), T))
        lane_trna.append(np.repeat(np.arange(T), len(ws)))
        wins += [(e, strand, w) for strand, w in ws]
    lane_win = np.concatenate(lane_win or [np.zeros(0, np.int64)])
    lane_trna = np.concatenate(lane_trna or [np.zeros(0, np.int64)])
    n = lane_win.size
    tr["lanes"] = tr.get("lanes", 0) + n
    out: list[list[PBSHit]] = [[] for _ in elements]
    if n == 0:
        return out
    trnas = [revcomp_str(t) for _, t in trna_lib]
    V = max(1, max(len(t) for t in trnas))
    vc = np.full((T, V), 255, np.int32)
    vi = np.full((T, V), -1, np.int32)
    for k, t in enumerate(trnas):
        vc[k, :len(t)], vi[k, :len(t)] = codes(t)
    uc = np.empty((len(wins), W), np.int32)
    ui = np.empty((len(wins), W), np.int32)
    for k, (_, _, w) in enumerate(wins):
        uc[k], ui[k] = codes(w)
    vlen = np.asarray([len(t) for t in trnas], np.int64)
    uc_d, ui_d, vc_d, vi_d, vlen_d, lw_d, lt_d = (
        torch.from_numpy(a).to(dev)
        for a in (uc, ui, vc, vi, vlen, lane_win, lane_trna))
    per_lane = 4 * (V + 1) * (W + 1 + _LANE_ROWS)
    chunk_lanes = max(1, CHUNK_BYTES[dev.type] // per_lane)
    res = []
    for c0 in range(0, n, chunk_lanes):
        w, t = lw_d[c0:c0 + chunk_lanes], lt_d[c0:c0 + chunk_lanes]
        res.append(_sw_lanes(uc_d[w], vc_d[t], vlen_d[t], ui_d[w], vi_d[t],
                             params, tr).cpu())
    t0 = time.perf_counter()
    score, ustart, uend, vstart, edist = \
        torch.cat(res).numpy().astype(np.int64).T
    keep = (score > 0) & _pbs_keep(edist, np.abs(r - ustart),
                                   uend - ustart + 1, vstart, params)
    for k in np.flatnonzero(keep):
        e, strand, _ = wins[lane_win[k]]
        seq, lrel, rrel, start = elements[e]
        desc, trna = trna_lib[lane_trna[k]]
        out[e].append(_pbs_hit(strand, int(ustart[k]), int(uend[k]),
                               int(vstart[k]), int(edist[k]), desc,
                               len(trna), seq, lrel, rrel, start, params))
    for hits in out:
        hits.sort(key=lambda h: -h.score)
    tr["filters_s"] = tr.get("filters_s", 0.0) + time.perf_counter() - t0
    return out


def ltr_elements(nodes, mapping) -> list[tuple]:
    """The LTR_retrotransposon features of nodes that have two LTRs, in
    ltrdigest's order: (feature, sequence, left LTR, right LTR, both
    LTRs relative to the element)."""
    elems = []
    for top in nodes:
        if not isinstance(top, FeatureNode):
            continue
        for fn in top.traverse():
            if fn.type != "LTR_retrotransposon":
                continue
            ltrs = sorted((c for c in fn.children
                           if c.type == "long_terminal_repeat"),
                          key=lambda c: c.range.start)
            if len(ltrs) != 2:
                continue
            leftltr, rightltr = ltrs[0].range, ltrs[1].range
            seq = mapping.get_sequence(fn.seqid, fn.range.start,
                                       fn.range.end)
            lrel = Range(leftltr.start - fn.range.start + 1,
                         leftltr.end - fn.range.start + 1)
            rrel = Range(rightltr.start - fn.range.start + 1,
                         rightltr.end - fn.range.start + 1)
            elems.append((fn, seq, Range(leftltr.start, leftltr.end),
                          Range(rightltr.start, rightltr.end), lrel, rrel))
    return elems


def ltrdigest(nodes, mapping, trna_lib=None,
              params: LTRdigestParams | None = None, device="cuda",
              engine: str = "batch", trace: dict | None = None):
    """Annotate LTR_retrotransposon features with RR_tract / U_box and
    primer_binding_site children (in place; returns nodes)
    (ref: gt_ltrdigest.c stream). engine "batch" runs the PBS search of
    every element as one batch on device (pbs_find_batch), "host" one
    alignment at a time (pbs_find), as the reference does. trace, when a
    dict, gains the element and lane counts and the seconds of the PPT
    and PBS searches."""
    params = params or LTRdigestParams()
    if engine not in ("batch", "host"):
        raise ValueError(f"unknown engine {engine!r}")
    tr = trace if trace is not None else {}
    elems = ltr_elements(nodes, mapping)
    tr["elements"] = len(elems)
    t0 = time.perf_counter()
    pbs_all = [[] for _ in elems]
    if trna_lib:
        if engine == "host":
            pbs_all = [pbs_find(seq, lrel, rrel, fn.range.start, trna_lib,
                                params)
                       for fn, seq, _, _, lrel, rrel in elems]
        else:
            pbs_all = pbs_find_batch(
                [(seq, lrel, rrel, fn.range.start)
                 for fn, seq, _, _, lrel, rrel in elems],
                trna_lib, params, device=device, trace=tr)
    t1 = time.perf_counter()
    tr["pbs_s"] = t1 - t0
    for (fn, seq, leftltr, rightltr, _, _), pbs_hits in zip(elems, pbs_all):
        hits = ppt_find(seq, leftltr, rightltr, fn.range.start, params)
        strand = None
        if hits:
            best = hits[0]
            strand = best.strand
            ppt = FeatureNode(fn.seqid, "RR_tract", best.rng.start,
                              best.rng.end, best.strand,
                              LTRDIGEST_TAG)
            fn.add_child(ppt)
            if best.ubox is not None:
                fn.add_child(FeatureNode(
                    fn.seqid, "U_box", best.ubox.start,
                    best.ubox.end, best.strand, LTRDIGEST_TAG))
        if pbs_hits:
            b = pbs_hits[0]
            pbs = FeatureNode(fn.seqid, "primer_binding_site",
                              b.rng.start, b.rng.end, b.strand,
                              LTRDIGEST_TAG, score=b.score)
            # ref: ltrdigest_pbs_visitor.c:399-409
            pbs.set_attribute("trna", b.trna)
            pbs.set_attribute("trnaoffset", str(b.trna_offset))
            pbs.set_attribute("pbsoffset", str(b.offset))
            pbs.set_attribute("edist", str(b.edist))
            fn.add_child(pbs)
            if strand is None:
                strand = b.strand
        if strand is not None:
            # ref: ltrdigest_ppt_visitor.c:498 sets the mainnode
            # strand; unknown-strand descendants follow suit
            fn.strand = strand
            for m in fn.traverse():
                if m.strand in (".", "?"):
                    m.strand = strand
    tr["ppt_s"] = time.perf_counter() - t1
    return nodes


def ltrdigest_file_out(nodes, mapping, prefix: str,
                       seqnamelen: int = 20) -> None:
    """Tabular + FASTA file family of `gt ltrdigest -outfileprefix`
    (capability of ltrdigest_file_out_stream, ref:
    src/ltr/ltrdigest_file_out_stream.c): writes
    <prefix>_tabout.csv (header + one row per element),
    <prefix>_{5ltr,3ltr,complete,ppt,pbs}.fas."""

    def fa(path):
        return open(path, "w")

    def show(f, desc, seq, width=60):
        f.write(f">{desc}\n")
        for i in range(0, len(seq), width):
            f.write(seq[i:i + width] + "\n")

    tab = open(prefix + "_tabout.csv", "w")
    tab.write(
        "element start\telement end\telement length\tsequence\t"
        "lLTR start\tlLTR end\tlLTR length\t"
        "rLTR start\trLTR end\trLTR length\t"
        "lTSD start\tlTSD end\tlTSD motif\t"
        "rTSD start\trTSD end\trTSD motif\t"
        "PPT start\tPPT end\tPPT motif\tPPT strand\tPPT offset"
        "\tPBS start\tPBS end\tPBS strand\ttRNA\ttRNA motif\tPBS "
        "offset\ttRNA offset\tPBS/tRNA edist\n")
    f5 = fa(prefix + "_5ltr.fas")
    f3 = fa(prefix + "_3ltr.fas")
    fc = fa(prefix + "_complete.fas")
    fp = fa(prefix + "_ppt.fas")
    fb = fa(prefix + "_pbs.fas")
    try:
        for top in nodes:
            if not isinstance(top, FeatureNode):
                continue
            for fn in top.traverse():
                if fn.type != "LTR_retrotransposon":
                    continue
                ltrs = sorted((c for c in fn.children
                               if c.type == "long_terminal_repeat"),
                              key=lambda c: c.range.start)
                if len(ltrs) != 2:
                    continue
                sid = fn.seqid.replace(" ", "_")[:seqnamelen]
                er, lr, rr = fn.range, ltrs[0].range, ltrs[1].range
                desc = f"{sid}_{er.start}_{er.end}"
                row = [er.start, er.end, er.end - er.start + 1, sid,
                       lr.start, lr.end, lr.end - lr.start + 1,
                       rr.start, rr.end, rr.end - rr.start + 1]

                def seq_of(rng):
                    return mapping.get_sequence(fn.seqid, rng.start,
                                                rng.end)

                # on the minus strand 5'/3' LTR roles swap
                # (ref: gt_ltrelement_*ltrlen role logic)
                minus = fn.strand == "-"
                show(f5, f"{desc}_5ltr",
                     seq_of(rr if minus else lr))
                show(f3, f"{desc}_3ltr",
                     seq_of(lr if minus else rr))
                show(fc, desc, seq_of(er))
                kids = {c.type: c for c in fn.children}
                tsds = [c for c in (top.children
                                    if top.type == "repeat_region"
                                    else [])
                        if c.type == "target_site_duplication"]
                tsds = sorted(tsds, key=lambda c: c.range.start)
                for t in (tsds[:1], tsds[1:2]):
                    if t:
                        tr = t[0].range
                        row += [tr.start, tr.end, seq_of(tr)]
                    else:
                        row += ["", "", ""]
                ppt = kids.get("RR_tract")
                if ppt is not None:
                    pr = ppt.range
                    off = abs(rr.start - pr.end) \
                        if ppt.strand == "+" else abs(lr.end - pr.start)
                    row += [pr.start, pr.end, seq_of(pr), ppt.strand,
                            off]
                    show(fp, f"{desc}_ppt", seq_of(pr))
                else:
                    row += ["", "", "", "", ""]
                pbs = kids.get("primer_binding_site")
                if pbs is not None:
                    br = pbs.range
                    row += [br.start, br.end, pbs.strand,
                            pbs.get_attribute("trna") or "",
                            seq_of(br),
                            pbs.get_attribute("pbsoffset") or "",
                            pbs.get_attribute("trnaoffset") or "",
                            pbs.get_attribute("edist") or ""]
                    show(fb, f"{desc}_pbs", seq_of(br))
                else:
                    row += [""] * 8
                tab.write("\t".join(str(x) for x in row) + "\n")
    finally:
        for f in (tab, f5, f3, fc, fp, fb):
            f.close()
