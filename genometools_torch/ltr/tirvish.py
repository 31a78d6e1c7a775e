"""TIRvish: terminal inverted repeat discovery (`gt tirvish`).

The port's counterpart of ``genometools_tpu/ltr/tirvish.py`` (ref:
src/extended/tir_stream.c, src/tools/gt_tir.c): seeds are maximal
repeats between a sequence and its reverse complement, found on the
mirrored encseq (ref: tir_stream.c:135 gt_tir_store_seeds over
gt_enumeratemaxpairs), whose index is sorted on the card; each seed is
xdrop-extended on both flanks with the user's scores (ref:
tir_stream.c:456 gt_tir_searchforTIRs); the TIR pair is TSD-adjusted
(the best target-site duplication in the boundary vicinities, ref:
tir_stream.c:306 gt_tir_find_best_TSD), filtered by arm similarity
(greedy unit edit distance), sorted, overlap-resolved, and emitted as
the reference's GFF3 hierarchy (repeat_region > target_site_duplication
x2 + terminal_inverted_repeat_element > terminal_inverted_repeat x2,
ref: tir_stream.c:878-944).

The reference extends one seed at a time on the host. Here the span,
distance and contig filters run over all seeds at once, and the left
and right arms go through ``ops/xdrop_batch.py::xdrop_extend_batch_pool``
in two batches over the mirrored codes, uploaded once (K3 at quantum 4
for the default scores; the scalar engine for scores whose unit
distances are not (1, 1, 1)). The TSD search and the arm similarity
run once per distinct pair of arms, on both routes. ``engine="host"``
keeps the reference's per-seed extensions as the oracle.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ..core.encseq import Encseq
from ..device import resolve_device
from ..index.esa import build_esa
from ..match.maxpairs import enumerate_maxpairs
from ..ops.pool import upload_pool
from ..ops.xdrop import XdropScores, xdrop_extend
from ..ops.xdrop_batch import check_belowscore, xdrop_extend_batch_pool


@dataclass
class TIRvishParams:
    """Defaults mirror gt tirvish (ref: src/tools/gt_tir.c:142-233)."""
    min_seed_length: int = 20
    min_tir_length: int = 100
    max_tir_length: int = 1000
    min_tir_distance: int = 500
    max_tir_distance: int = 10000
    mat: int = 2
    mis: int = -2
    ins: int = -3
    dele: int = -3
    xdrop_belowscore: int = 5
    similarity_threshold: float = 85.0
    min_tsd_length: int = 2
    max_tsd_length: int = 11
    vicinity: int = 60
    overlaps: str = "best"          # best | longest | no | all


@dataclass
class TIRPair:
    contignumber: int
    left_tir_start: int
    left_tir_end: int
    right_tir_start: int            # mirror coordinates (revcomp half)
    right_tir_end: int
    right_transformed_start: int
    right_transformed_end: int
    similarity: float = 0.0
    tsd_length: int = 0
    skip: bool = False


def _scores(p: TIRvishParams) -> XdropScores:
    return XdropScores(mat=p.mat, mis=p.mis, ins=p.ins, del_=p.dele)


def _xdrop_extend(u: np.ndarray, v: np.ndarray, p: TIRvishParams):
    """gt_evalxdroparbitscoresextend on forward windows; returns
    (ivalue, jvalue)."""
    if u.size == 0 or v.size == 0:
        return 0, 0
    best = xdrop_extend(u, v, p.xdrop_belowscore, _scores(p))
    return int(best.ivalue), int(best.jvalue)


def _unit_edist(u: np.ndarray, v: np.ndarray) -> int:
    """greedyunitedist (ref: tir_stream.c:612): unit-cost edit distance
    of the two arms — O((n+m)d) greedy diagonal front."""
    n, m = u.size, v.size
    if n == 0 or m == 0:
        return max(n, m)
    # Myers O(nd) greedy: fronts over diagonals
    maxd = n + m
    off = maxd
    V = np.full(2 * maxd + 2, -1, np.int64)
    V[off + 1] = 0
    for d in range(maxd + 1):
        for k in range(-d, d + 1, 2):
            if k == -d or (k != d and V[off + k - 1] < V[off + k + 1]):
                x = V[off + k + 1]
            else:
                x = V[off + k - 1] + 1
            y = x - k
            while x < n and y < m and u[x] == v[y] and u[x] < 4 \
                    and v[y] < 4:
                x += 1
                y += 1
            V[off + k] = x
            if x >= n and y >= m:
                return d
    return maxd


def _tsd_matches(db: np.ndarray, query: np.ndarray, minlen: int):
    """gt_sarrquerysubstringmatch equivalent: for each query position,
    the longest db-matching prefix; every db occurrence reported when
    >= minlen. Yields (dbstart, querystart, length), by query position,
    then db position. The reference compares each (db, query) start pair
    in a scalar loop; here the common run of every pair comes from one
    table, run[s, q] = run[s+1, q+1] + 1 where db[s] and query[q] are
    equal regular symbols (0 elsewhere), filled one row at a time."""
    n, m = db.size, query.size
    if n == 0 or m == 0:
        return []
    db = db.astype(np.int16)
    query = query.astype(np.int16)
    eq = (db[:, None] == query[None, :]) & (db[:, None] < 4) & \
        (query[None, :] < 4)
    run = np.zeros((n + 1, m + 1), np.int64)
    for s in range(n - 1, -1, -1):
        run[s, :m] = np.where(eq[s], run[s + 1, 1:] + 1, 0)
    run = run[:n, :m]
    best = run.max(axis=0)
    out = []
    for q0 in np.flatnonzero((query < 4) & (best >= minlen)):
        for s in np.flatnonzero(run[:, q0] == best[q0]):
            out.append((int(s), int(q0), int(best[q0])))
    return out


def tirvish(encseq: Encseq, params: TIRvishParams | None = None,
            device="cuda", engine: str = "batch",
            trace: dict | None = None) -> list[TIRPair]:
    """Run the full TIR pipeline on an (unmirrored) encseq. engine
    "batch" extends through the device batches, "host" seed by seed as
    the reference does. trace, when a dict, gains the counts and the
    seconds of each step."""
    p = params or TIRvishParams()
    dev = resolve_device(device)
    if engine == "batch":
        check_belowscore(p.xdrop_belowscore, _scores(p))
    tr = trace if trace is not None else {}
    t0 = time.perf_counter()
    m = encseq.mirror()
    esa = build_esa(m, device=dev)
    t1 = time.perf_counter()
    mp = enumerate_maxpairs(esa, p.min_seed_length)
    t2 = time.perf_counter()
    tr.update(maxpairs=mp.count, build_esa_s=t1 - t0, maxpairs_s=t2 - t1)
    pos1 = np.minimum(mp.pos1, mp.pos2).astype(np.int64)
    pos2 = np.maximum(mp.pos1, mp.pos2).astype(np.int64)
    slen = mp.length.astype(np.int64)
    if engine == "host":
        rows = _host_arms(m, encseq.total_length, pos1, pos2, slen, p)
    elif engine == "batch":
        rows = _batch_arms(m, encseq.total_length, pos1, pos2, slen, p,
                           dev, tr)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    t3 = time.perf_counter()
    pairs = _pairs(m, rows, p)
    tr.update(pairs=len(pairs), predictions=sum(not q.skip for q in pairs),
              arms_s=t3 - t2, pairs_s=time.perf_counter() - t3)
    pairs.sort(key=lambda q: (q.contignumber, q.left_tir_start,
                              q.right_transformed_start))
    if p.overlaps in ("best", "longest", "no"):
        _remove_overlaps(pairs, p.overlaps)
    return [q for q in pairs if not q.skip]


def _host_arms(m: Encseq, midpos: int, pos1, pos2, slen,
               p: TIRvishParams) -> list:
    """The reference's route, seed by seed: (seq1, left_start, left_end,
    right_start, right_end) of every seed that passes its filters and
    the TIR length bounds."""
    codes = m.codes
    total = m.total_length
    nseq_m = m.num_sequences
    rows = []
    for i in range(pos1.size):
        a, b, sl = int(pos1[i]), int(pos2[i]), int(slen[i])
        # seed must span the two halves (ref: tir_stream.c:153)
        if a > midpos or b < midpos:
            continue
        distance = (total - 1 - b - sl + 1) - a
        if distance < p.min_tir_distance or distance > p.max_tir_distance:
            continue
        seq1 = int(m.seqnum_of_pos(a))
        seq2 = int(m.seqnum_of_pos(b))
        if seq2 != nseq_m - seq1 - 1:
            continue
        if sl > p.max_tir_length:
            continue
        seqstart1 = int(m.seq_startpos(seq1))
        seqend1 = seqstart1 + int(m.seq_length(seq1))
        seqstart2 = total - seqend1
        seqend2 = total - seqstart1
        alilen = p.max_tir_length - sl
        # left xdrop on reversed prefixes (ref: tir_stream.c:495-523)
        li = lj = 0
        if alilen and a > seqstart1 and b > seqstart2:
            ext = min(alilen, a - seqstart1, b - seqstart2)
            u = codes[a - ext:a][::-1].copy()
            v = codes[b - ext:b][::-1].copy()
            li, lj = _xdrop_extend(u, v, p)
        # right xdrop on forward suffixes
        ri = rj = 0
        if alilen and a + sl < seqend1 and b + sl < seqend2:
            ext = min(alilen, seqend1 - (a + sl), seqend2 - (b + sl))
            u = codes[a + sl:a + sl + ext]
            v = codes[b + sl:b + sl + ext]
            ri, rj = _xdrop_extend(u, v, p)
        left_start, left_end = a - li, a + sl - 1 + ri
        tirlen = left_end - left_start
        if tirlen < p.min_tir_length or tirlen > p.max_tir_length:
            continue
        rows.append((seq1, left_start, left_end, b - lj, b + sl - 1 + rj))
    return rows


def _batch_arms(m: Encseq, midpos: int, pos1, pos2, slen,
                p: TIRvishParams, dev, tr: dict) -> list:
    """``_host_arms`` with the filters over all seeds at once and both
    arms of every seed in two batches of xdrop lanes."""
    t0 = time.perf_counter()
    codes = m.codes
    total = m.total_length
    distance = (total - 1 - pos2 - slen + 1) - pos1
    seq1 = m.seqnum_of_pos(pos1)
    keep = ~((pos1 > midpos) | (pos2 < midpos)) & \
        (distance >= p.min_tir_distance) & \
        (distance <= p.max_tir_distance) & \
        (m.seqnum_of_pos(pos2) == m.num_sequences - seq1 - 1) & \
        (slen <= p.max_tir_length)
    a, b, sl, seq1 = pos1[keep], pos2[keep], slen[keep], seq1[keep]
    seqstart1 = m.seq_startpos(seq1).astype(np.int64)
    seqend1 = seqstart1 + m.seq_length(seq1).astype(np.int64)
    seqstart2, seqend2 = total - seqend1, total - seqstart1
    alilen = p.max_tir_length - sl
    # the windows of both arms, bounded by alilen (tirvish.py:167-184)
    lext = np.where((alilen > 0) & (a > seqstart1) & (b > seqstart2),
                    np.minimum(alilen, np.minimum(a - seqstart1,
                                                  b - seqstart2)), 0)
    rext = np.where((alilen > 0) & (a + sl < seqend1) & (b + sl < seqend2),
                    np.minimum(alilen, np.minimum(seqend1 - (a + sl),
                                                  seqend2 - (b + sl))), 0)
    t1 = time.perf_counter()
    gp = upload_pool(codes, dev)
    li, lj = _extend_side(codes, gp, a - lext, b - lext, lext, True, p, dev)
    ri, rj = _extend_side(codes, gp, a + sl, b + sl, rext, False, p, dev)
    t2 = time.perf_counter()
    left_start, left_end = a - li, a + sl - 1 + ri
    tirlen = left_end - left_start
    ok = (tirlen >= p.min_tir_length) & (tirlen <= p.max_tir_length)
    rows = np.stack([seq1, left_start, left_end, b - lj, b + sl - 1 + rj],
                    axis=1)[ok]
    tr.update(seeds=int(a.size), lanes=int((lext > 0).sum() +
                                           (rext > 0).sum()),
              filters_s=(t1 - t0) + (time.perf_counter() - t2),
              extensions_s=t2 - t1)
    return [tuple(int(x) for x in r) for r in rows]


def _extend_side(codes, gp, u_off, v_off, ext, rev: bool,
                 p: TIRvishParams, dev):
    """(ivalue, jvalue) of one arm of every seed: u = codes[u_off:+ext],
    v = codes[v_off:+ext], both reversed when rev; an empty window gives
    (0, 0) and skips the batch."""
    iv = np.zeros(ext.size, np.int64)
    jv = np.zeros(ext.size, np.int64)
    run = np.flatnonzero(ext > 0)
    if run.size:
        i, j, _ = xdrop_extend_batch_pool(
            codes, u_off[run], ext[run], v_off[run], ext[run],
            np.full(run.size, rev), p.xdrop_belowscore, _scores(p),
            device=dev, gp=gp)
        iv[run], jv[run] = i, j
    return iv, jv


def _pairs(m: Encseq, rows, p: TIRvishParams) -> list[TIRPair]:
    """The TIR pairs of the extended seeds, TSD-adjusted and with their
    arm similarity (ref: tirvish.py:186-218); the TSD search and the
    similarity run once per distinct row (they depend on nothing
    else)."""
    codes = m.codes
    total = m.total_length
    done: dict = {}
    pairs = []
    for row in rows:
        got = done.get(row)
        if got is None:
            seq1, left_start, left_end, right_start, right_end = row
            pair = TIRPair(
                contignumber=seq1,
                left_tir_start=left_start,
                left_tir_end=left_end,
                right_tir_start=right_start,
                right_tir_end=right_end,
                right_transformed_start=total - 1 - right_end,
                right_transformed_end=total - 1 - right_start)
            seqstart1 = int(m.seq_startpos(seq1))
            _search_tsds(m, pair, p, seqstart1,
                         seqstart1 + int(m.seq_length(seq1)) - 1)
            if not pair.skip and (pair.left_tir_end <= pair.left_tir_start
                                  or pair.right_transformed_end
                                  <= pair.right_transformed_start):
                pair.skip = True
            if not pair.skip:
                # reference compares the (TSD-adjusted) left arm to the
                # right arm IN MIRROR COORDINATES - i.e. already in the
                # left arm's orientation (ref: tir_stream.c:606-616)
                u = codes[pair.left_tir_start:pair.left_tir_end]
                v = codes[pair.right_tir_start:pair.right_tir_end]
                edist = _unit_edist(u, v)
                pair.similarity = 100.0 * (1.0 - edist / max(u.size, v.size))
                if pair.similarity < p.similarity_threshold:
                    pair.skip = True
            got = done[row] = pair
        pairs.append(TIRPair(**vars(got)))
    return pairs


def _search_tsds(m: Encseq, pair: TIRPair, p: TIRvishParams,
                 seq_start: int, seq_end: int) -> None:
    """ref: tir_stream.c:368 gt_tir_search_for_TSDs + find_best_TSD."""
    if p.min_tsd_length <= 1:
        return
    codes = m.codes
    start_left = max(seq_start, pair.left_tir_start - p.vicinity)
    end_left = min(pair.left_tir_end,
                   pair.left_tir_start + p.vicinity)
    start_right = max(pair.right_transformed_start,
                      pair.right_transformed_end - p.vicinity)
    end_right = min(seq_end, pair.right_transformed_end + p.vicinity)
    db = codes[start_left:end_left + 1]
    query = codes[start_right:end_right + 1]
    tsds = _tsd_matches(db, query, p.min_tsd_length)
    best_cost = None
    new_left = pair.left_tir_start
    new_right = pair.right_transformed_end
    best_len = 0
    for s, q0, tlen in tsds:
        pos1 = start_left + s
        offset = (start_right + q0) - pos1
        if tlen < p.min_tsd_length or tlen >= p.max_tsd_length:
            continue
        cost_left = abs((pos1 + tlen - 1) - pair.left_tir_start)
        cost_right = abs((pos1 + offset) - pair.right_transformed_end)
        cost = cost_left + cost_right
        if best_cost is None or cost < best_cost:
            best_cost = cost
            new_left = pos1 + tlen
            new_right = pos1 + offset - 1
            best_len = tlen
    if tsds:
        pair.left_tir_start = new_left
        pair.right_transformed_end = new_right
        pair.tsd_length = best_len
    else:
        pair.skip = True
    if pair.right_transformed_end <= pair.right_transformed_start:
        pair.skip = True
    if pair.left_tir_end <= pair.left_tir_start:
        pair.skip = True
    if pair.tsd_length == 0:
        pair.skip = True


def _remove_overlaps(pairs: list[TIRPair], mode: str) -> None:
    """ref: tir_stream.c:220 gt_tir_remove_overlaps."""
    live = [q for q in pairs if not q.skip]
    if not live:
        return
    ref_start = live[0].left_tir_start
    ref_end = live[0].right_transformed_end
    old = best = longest = live[0]
    for b in live[1:]:
        if b.left_tir_start <= ref_end and ref_start \
                <= b.right_transformed_end:
            ref_end = max(b.right_transformed_end, ref_end)
            if mode == "no":
                old.skip = True
                b.skip = True
            elif mode == "longest":
                if (longest.right_transformed_end
                        - longest.left_tir_start) < \
                        (b.right_transformed_end - b.left_tir_start):
                    longest.skip = True
                    longest = b
                else:
                    b.skip = True
            else:
                if best.similarity < b.similarity:
                    best.skip = True
                    best = b
                else:
                    b.skip = True
        else:
            old = best = longest = b
            ref_start = b.left_tir_start
            ref_end = b.right_transformed_end


def gff3_nodes(pairs: list[TIRPair], encseq: Encseq):
    """The reference's GFF3 hierarchy (ref: tir_stream.c:878-944);
    coordinates 1-based relative to the contig."""
    from ..anno.genome_node import FeatureNode, RegionNode
    mirrored = encseq.mirror()
    nodes = []
    with_tsd = any(q.tsd_length for q in pairs)
    regions: dict[int, tuple[int, int]] = {}
    for q in pairs:
        s0 = int(mirrored.seq_startpos(q.contignumber))
        a = q.left_tir_start - s0 - q.tsd_length + 1
        b = q.right_transformed_end - s0 + q.tsd_length + 1
        lo, hi = regions.get(q.contignumber, (a, b))
        regions[q.contignumber] = (min(lo, a), max(hi, b))
    for cn in sorted(regions):
        nodes.append(RegionNode(f"seq{cn}", *regions[cn]))
    for q in pairs:
        s0 = int(mirrored.seq_startpos(q.contignumber))
        seqid = f"seq{q.contignumber}"
        region = FeatureNode(
            seqid, "repeat_region",
            q.left_tir_start - s0 - q.tsd_length + 1,
            q.right_transformed_end - s0 + q.tsd_length + 1,
            "?", "TIRvish")
        if q.tsd_length and with_tsd:
            region.add_child(FeatureNode(
                seqid, "target_site_duplication",
                q.left_tir_start - s0 + 1 - q.tsd_length,
                q.left_tir_start - s0, "?", "TIRvish"))
            region.add_child(FeatureNode(
                seqid, "target_site_duplication",
                q.right_transformed_end - s0 + 2,
                q.right_transformed_end - s0 + 1 + q.tsd_length,
                "?", "TIRvish"))
        elem = FeatureNode(
            seqid, "terminal_inverted_repeat_element",
            q.left_tir_start - s0 + 1,
            q.right_transformed_end - s0 + 1, "?", "TIRvish")
        elem.attributes["tir_similarity"] = f"{q.similarity:.2f}"
        region.add_child(elem)
        elem.add_child(FeatureNode(seqid, "terminal_inverted_repeat",
                                   q.left_tir_start - s0 + 1,
                                   q.left_tir_end - s0 + 1, "?",
                                   "TIRvish"))
        elem.add_child(FeatureNode(seqid, "terminal_inverted_repeat",
                                   q.right_transformed_start - s0 + 1,
                                   q.right_transformed_end - s0 + 1, "?",
                                   "TIRvish"))
        nodes.append(region)
    return nodes


def refseq_match_annotate(nodes, encseq, refseq_paths,
                          min_ali_len_perc: float = 10.0,
                          flcands: bool = False,
                          source: str = "GenomeTools", device="cuda"):
    """Annotate candidate elements with their best reference-sequence
    match (capability of ltr_refseq_match_stream, ref:
    src/ltr/ltr_refseq_match_stream.c) — the reference shells out to
    BLASTN; here the port's seed_extend (greedy, K1 on the card) does
    the matching.  Adds a `nucleotide_match` child (target = the
    refseq description, similarity + match coordinates as attributes)
    to every element whose best alignment covers at least
    ``min_ali_len_perc`` percent of the element."""
    from ..anno.genome_node import FeatureNode
    from ..core.alphabet import dna_alphabet
    from ..match.seed_extend import SeedExtendParams, seed_extend

    ref = Encseq.from_files(list(refseq_paths))
    params = SeedExtendParams(minidentity=80, extension="greedy",
                              userdefinedleastlength=20)
    for top in nodes:
        if not isinstance(top, FeatureNode):
            continue
        for fn in top.traverse():
            if fn.type not in ("LTR_retrotransposon",
                               "terminal_inverted_repeat_element",
                               "repeat_region"):
                continue
            if fn.type == "repeat_region":
                continue
            rng = fn.range
            seqnum = 0
            try:
                seqnum = int(fn.get_attribute("seq_number") or 0)
            except (TypeError, ValueError):
                pass
            start = int(encseq.seq_startpos(seqnum))
            sub = encseq.codes[start + rng.start - 1:start + rng.end]
            cand = Encseq.from_string(dna_alphabet().decode(sub))
            matches = seed_extend(cand, ref, params, device=device)
            if not matches:
                continue
            best = max(matches, key=lambda m: m.dblen)
            elen = rng.end - rng.start + 1
            if 100.0 * best.dblen / elen < min_ali_len_perc:
                continue
            if flcands and best.dblen < elen:
                continue
            desc = ref.descs[best.queryseqnum] \
                if best.queryseqnum < len(ref.descs) else ""
            child = FeatureNode(fn.seqid, "nucleotide_match",
                                rng.start + best.dbstart,
                                rng.start + best.dbstart +
                                best.dblen - 1,
                                best.direction == "P" and "-" or "+",
                                source)
            child.set_attribute("target", desc.split()[0] if desc
                                else "unknown")
            child.set_attribute("similarity",
                                f"{best.identity:.2f}")
            child.set_attribute("matchlen", str(best.dblen))
            fn.add_child(child)
    return nodes
