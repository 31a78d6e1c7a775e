"""Position-sharded distributed prefix doubling over a mesh of devices.

The port of ``genometools_tpu/parallel/dist_doubling_sharded.py``. Shard
m owns the ranks of positions [m*C, (m+1)*C); every per-shard array is
O(n/P) and every round's exchanges move O(n/P) items a shard:

  * ``rank[i+h]`` of a block is a shifted block fetch: two ``ppermute``s
    from the static neighbours m+q and m+q+1;
  * the block-bitonic engine (``sharded_build_sa``) sorts each round's
    (rank, rank[i+h], pos) tuples with merge-split compare-exchanges
    between sorted C-blocks: log2(P)(log2(P)+1)/2 steps of C items, for
    any input (0-1 principle), powers of two only;
  * the sample-sort engine (``sharded_build_sa_sample``, the default)
    sorts locally, broadcasts P-1 regular-sample splitters, routes each
    row to its bucket's owner in two balanced hops (each (source, final
    destination) class spread round-robin over P intermediates, so every
    per-pair buffer holds at most ceil(rows/P) + 2P rows for any input)
    and returns each row's new dense rank through the same buffers: the
    slot permutation of a tiled all_to_all is an involution, so
    positions never travel. An overflow flag is still kept; the host
    wrapper falls back to the bitonic engine if it is ever set.

The reference carries values past int32 as (hi, lo) int32 planes in base
C because a TPU has no int64. Here the wide lanes are the sample-sort
engine itself over int64 columns: the same bytes a position, no carry
arithmetic. The wrapper pads the keys to a multiple of the mesh size
(the reference to a power of two), with keys above every real key.
Rounds stop when every rank is distinct, read on the host each round.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .mesh import (Mesh, all_gather, all_to_all, bucket_order, gather,
                   lexsort, lexsort_order, pmax, ppermute, psum)

_BOOT = 4  # bootstrap prefix width (index.suffix._BOOT)


def _cols(blocks, c):
    """Column c of per-shard column lists, as a sharded array."""
    return [b[c] for b in blocks]


def _block_bitonic_sort(blocks: list, num_keys: int) -> list:
    """Distributed sort of P C-blocks of tuple columns (blocks[m]: shard
    m's list of columns). Returns the globally sorted sequence, its m-th
    C-block on shard m. Merge-split bitonic network over sorted blocks."""
    nP = len(blocks)
    C = blocks[0][0].shape[0]
    ncol = len(blocks[0])
    blocks = [lexsort(b, num_keys) for b in blocks]
    logp = nP.bit_length() - 1
    for k in range(1, logp + 1):
        for j in range(k - 1, -1, -1):
            perm = [(i, i ^ (1 << j)) for i in range(nP)]
            recv = [ppermute(_cols(blocks, c), perm) for c in range(ncol)]
            new = []
            for m in range(nP):
                low_first = m < m ^ (1 << j)
                # canonical concatenation (lower shard first): both
                # partners sort the same sequence, so a stable sort
                # splits ties the same way on both sides
                merged = lexsort(
                    [torch.cat([a, recv[c][m]] if low_first
                               else [recv[c][m], a])
                     for c, a in enumerate(blocks[m])], num_keys)
                keep_low = (((m >> k) & 1) == 0) == low_first
                new.append([a[:C] if keep_low else a[C:] for a in merged])
            blocks = new
    return blocks


def _shifted_fetch(blks: list, h: int, fill) -> list:
    """out[m][j] = global_array[m*C + j + h] (fill beyond the end); two
    ppermutes move exactly one block a shard."""
    nP = len(blks)
    C = blks[0].shape[0]
    n1 = nP * C
    q, rrem = divmod(h, C)
    if q < nP:
        a = ppermute(blks, [(i, i - q) for i in range(q, nP)])
    else:
        a = [torch.zeros_like(b) for b in blks]
    if rrem and q + 1 < nP:
        b = ppermute(blks, [(i, i - q - 1) for i in range(q + 1, nP)])
    else:
        b = [torch.zeros_like(x) for x in blks]
    out = []
    for m in range(nP):
        o = torch.cat([a[m][rrem:], b[m][:rrem]]) if rrem else a[m]
        pos = torch.arange(m * C, (m + 1) * C, device=o.device)
        out.append(torch.where(pos + h < n1, o, fill))
    return out


def _starts(keys: list, M: int, dev) -> torch.Tensor:
    neq = torch.zeros(M, dtype=torch.bool, device=dev)
    for s in keys:
        neq[1:] |= s[1:] != s[:-1]
    return neq


def _dense_rank_stitched(skeys: list):
    """Dense 0-based ranks of globally sorted tuple blocks (skeys[m]:
    shard m's key columns) and the global distinct count (per shard)."""
    nP = len(skeys)
    C = skeys[0][0].shape[0]
    dt = skeys[0][0].dtype
    nk = len(skeys[0])
    prev = [ppermute([s[c][-1:] for s in skeys],
                     [(i, i + 1) for i in range(nP - 1)]) for c in range(nk)]
    cums = []
    for m, keys in enumerate(skeys):
        dev = keys[0].device
        start = _starts(keys, C, dev)
        first = torch.zeros(1, dtype=torch.bool, device=dev)
        for c, s in enumerate(keys):
            first |= s[:1] != prev[c][m]
        start[:1] = first | (m == 0)
        cums.append(torch.cumsum(start, 0, dtype=dt))
    totals = all_gather([c[-1] for c in cums])
    ranks = [totals[m][:m].sum() + c - 1 for m, c in enumerate(cums)]
    return ranks, psum([c[-1] for c in cums])


def _positions(mesh: Mesh, C: int, dt) -> list:
    return [torch.arange(m * C, (m + 1) * C, dtype=dt, device=d)
            for m, d in enumerate(mesh.devices)]


def _levels(n1: int) -> int:
    return max(1, math.ceil(math.log2(max(n1 / _BOOT, 2))))


def _bootstrap_cols(kb: list) -> list:
    """The first _BOOT symbol keys of every position, per shard."""
    kcols = [kb] + [_shifted_fetch(kb, j, -1) for j in range(1, _BOOT)]
    return [[k[m] for k in kcols] for m in range(len(kb))]


def sharded_build_sa(keys, n1: int, mesh: Mesh) -> list:
    """Position-sharded prefix doubling with block-bitonic sorts. keys:
    a tensor of n1 suffix keys (int32 or int64), n1 a multiple of a
    power-of-two mesh size (pad like sharded_suffix_array). Returns the
    suffix array's per-shard blocks."""
    nP = mesh.size
    assert n1 % nP == 0 and nP & (nP - 1) == 0
    C = n1 // nP
    kb = mesh.shard(keys)
    pos = _positions(mesh, C, kb[0].dtype)
    srt = _block_bitonic_sort(
        [c + [p] for c, p in zip(_bootstrap_cols(kb), pos)], _BOOT)
    nr, _ = _dense_rank_stitched([s[:_BOOT] for s in srt])
    rank = _cols(_block_bitonic_sort(
        [[s[_BOOT], r] for s, r in zip(srt, nr)], 1), 1)
    for t in range(_levels(n1)):
        h = _BOOT << t
        if h >= n1:
            break
        r2 = _shifted_fetch(rank, h, -1)
        srt = _block_bitonic_sort(
            [[r, x, p] for r, x, p in zip(rank, r2, pos)], 2)
        nr, distinct = _dense_rank_stitched([s[:2] for s in srt])
        rank = _cols(_block_bitonic_sort(
            [[s[2], r] for s, r in zip(srt, nr)], 1), 1)
        if int(distinct[0]) == n1:
            break
    return _cols(_block_bitonic_sort(
        [[r, p] for r, p in zip(rank, pos)], 1), 1)


# ---------------------------------------------------------------------------
# sample-sort exchange
# ---------------------------------------------------------------------------

def _route(cols: list, dest: list, valid: list, K: int):
    """One-hop bucket route at per-(source, destination) capacity K.
    cols[m]: shard m's columns. Returns (received columns per shard,
    received validity, overflow per shard, ctx for _route_back). A
    received block holds each source's rows first, so the validity of
    a slot is its place below the count its source sent."""
    nP = len(dest)
    sends, counts, ctxs, ovf = [], [], [], []
    for m in range(nP):
        dev = dest[m].device
        S = dest[m].shape[0]
        d = torch.where(valid[m], dest[m].to(torch.int64), nP)
        order, d_s, starts = bucket_order(d, nP + 1)
        within = torch.arange(S, device=dev) - starts[d_s]
        live = d_s < nP
        ovf.append((live & (within >= K)).any())
        # rows past the capacity and invalid rows land in a ghost slot
        slot = torch.where(live & (within < K), d_s * K + within, nP * K)
        send = []
        for c in cols[m]:
            buf = torch.zeros(nP * K + 1, dtype=c.dtype, device=dev)
            buf[slot] = c[order]
            send.append(buf[:nP * K])
        sends.append(send)
        counts.append(torch.clamp(starts[1:nP + 1] - starts[:nP], max=K))
        ctxs.append((order, slot, S))
    recv = [all_to_all(_cols(sends, c)) for c in range(len(cols[0]))]
    rcnt = all_to_all(counts)
    rvalid = [(torch.arange(K, device=r.device)[None, :] < r[:, None])
              .reshape(-1) for r in rcnt]
    return ([[r[m] for r in recv] for m in range(nP)], rvalid, ovf,
            (ctxs, K))


def _route_back(vals: list, ctx) -> list:
    """One plane from receiver slots back to the matching _route call's
    input rows (zero where that input was invalid)."""
    ctxs, K = ctx
    ret = all_to_all(vals)
    out = []
    for r, (order, slot, S) in zip(ret, ctxs):
        nK = r.shape[0]
        picked = torch.where(slot < nK, r[slot.clamp(max=nK - 1)], 0)
        out.append(torch.zeros(S, dtype=r.dtype, device=r.device)
                   .scatter_(0, order, picked))
    return out


def _cap(rows: int, nP: int) -> int:
    """Per-pair capacity covering the two-hop worst case with margin."""
    return -(-rows // nP) + 2 * nP


def _route2(cols: list, dest: list, valid: list, src_max: int,
            dst_max: int):
    """Two-hop balanced route (module docstring) between two or more
    shards. Returns (received columns, received validity, overflow,
    ctx)."""
    nP = len(dest)
    order0s, cols0, inter, valid0 = [], [], [], []
    for m in range(nP):
        dev = dest[m].device
        S = dest[m].shape[0]
        d = torch.where(valid[m], dest[m].to(torch.int64), nP)
        order0, d0, starts = bucket_order(d, nP + 1)
        within0 = torch.arange(S, device=dev) - starts[d0]
        inter.append(within0 % nP)        # round-robin per destination
        cols0.append([c[order0] for c in cols[m]] + [d0])
        valid0.append(d0 < nP)
        order0s.append(order0)
    recv1, v1, o1, ctx1 = _route(cols0, inter, valid0, _cap(src_max, nP))
    fdest = [r[-1] for r in recv1]
    recv2, v2, o2, ctx2 = _route([r[:-1] for r in recv1], fdest, v1,
                                 _cap(dst_max, nP))
    return recv2, v2, [a | b for a, b in zip(o1, o2)], (order0s, ctx1, ctx2)


def _route2_back(vals: list, ctx) -> list:
    if ctx is None:                       # one shard: nothing routed
        return vals
    order0s, ctx1, ctx2 = ctx
    src = _route_back(_route_back(vals, ctx2), ctx1)
    return [torch.empty_like(s).scatter_(0, o, s)
            for s, o in zip(src, order0s)]


def _splitters(sorted_cols: list, C: int) -> list:
    """P-1 splitter tuples (per shard, replicated) from P regular samples
    a shard; sorted_cols[m]: shard m's sorted columns, whose last column
    makes rows globally distinct."""
    nP = len(sorted_cols)
    idx = torch.arange(nP) * C // nP
    gath = [all_gather([s[c][idx.to(s[c].device)] for s in sorted_cols])
            for c in range(len(sorted_cols[0]))]
    out = []
    for m in range(nP):
        ss = lexsort([g[m].reshape(-1) for g in gath], len(gath))
        pick = torch.arange(1, nP, device=ss[0].device) * nP
        out.append([s[pick] for s in ss])
    return out


def _dest_lex(cols: list, spl: list) -> torch.Tensor:
    """dest[i] = number of splitter tuples <=_lex row i."""
    S = cols[0].shape[0]
    dev = cols[0].device
    dest = torch.zeros(S, dtype=torch.int64, device=dev)
    for j in range(spl[0].shape[0]):
        eq = torch.ones(S, dtype=torch.bool, device=dev)
        gt = torch.zeros(S, dtype=torch.bool, device=dev)
        for c, s in zip(cols, spl):
            sj = s[j]
            gt |= eq & (c > sj)
            eq &= c == sj
        dest += gt | eq
    return dest


def _dense_rank_ragged(skeys: list, svalid: list):
    """Dense 0-based global ranks over ragged sorted blocks (valid rows
    a prefix; empty shards allowed). Returns (ranks in sorted order per
    shard, the global distinct count per shard)."""
    nP = len(skeys)
    dt = skeys[0][0].dtype
    R = [v.sum() for v in svalid]
    last = [[torch.where(r > 0, s[(r - 1).clamp(min=0)], -1) for s in k]
            for k, r in zip(skeys, R)]
    lasts = [all_gather([l[c] for l in last]) for c in range(len(skeys[0]))]
    counts = all_gather(R)
    cums = []
    for m, keys in enumerate(skeys):
        dev = keys[0].device
        M = keys[0].shape[0]
        idxs = torch.arange(nP, device=dev)
        jl = torch.where((idxs < m) & (counts[m] > 0), idxs, -1).max()
        first = jl < 0                    # no earlier non-empty shard
        for c, s in enumerate(keys):
            first = first | (s[0] != lasts[c][m][jl.clamp(min=0)])
        start = _starts(keys, M, dev)
        start[0] = first
        start &= svalid[m]
        cums.append(torch.cumsum(start, 0, dtype=dt))
    totals = all_gather([c[-1] for c in cums])
    ranks = [totals[m][:m].sum() + c - 1 for m, c in enumerate(cums)]
    return ranks, [t.sum() for t in totals]


def _exchange_rank_roundtrip(keycols: list, pos: list, C: int):
    """One distributed ranking step: sample-sort-route the key tuples
    (keycols[m]: shard m's key columns), dense-rank them at the
    receivers, return each row's rank to its (stationary) position
    owner. Returns (rank blocks, distinct count, overflow per shard)."""
    nP = len(pos)
    nk = len(keycols[0])
    if nP == 1:
        # one shard: nothing to route, every row valid
        recv, ctx = keycols, None
        rvalid = [torch.ones(C, dtype=torch.bool, device=pos[0].device)]
        ovf = [torch.zeros((), dtype=torch.bool, device=pos[0].device)]
    else:
        loc = [lexsort(k + [p], nk + 1) for k, p in zip(keycols, pos)]
        spl = _splitters(loc, C)
        del loc
        dest = [_dest_lex(k + [p], s) for k, p, s in zip(keycols, pos, spl)]
        ones = [torch.ones(C, dtype=torch.bool, device=p.device)
                for p in pos]
        recv, rvalid, ovf, ctx = _route2(keycols, dest, ones, C,
                                         2 * C + 2 * nP)
        del dest
    skeys, svalid, orders = [], [], []
    for cols, v in zip(recv, rvalid):
        # invalid slots sort last; the order IS the slot permutation
        order = lexsort_order(cols if nP == 1 else [~v] + cols)
        skeys.append([c[order] for c in cols])
        svalid.append(v[order])
        orders.append(order)
    del recv
    ranks, distinct = _dense_rank_ragged(skeys, svalid)
    vals = [torch.empty_like(r).scatter_(0, o, r)
            for r, o in zip(ranks, orders)]
    return _route2_back(vals, ctx), distinct, ovf


def sharded_build_sa_sample(keys, n1: int, mesh: Mesh):
    """Position-sharded prefix doubling with sample-sort exchanges, on
    the keys' integer type (int32 lanes, or int64: the wide lanes).
    Same contract as sharded_build_sa (any mesh size), plus the overflow
    flag (int 0/1): nonzero would mean an exchange dropped rows."""
    nP = mesh.size
    assert n1 % nP == 0
    C = n1 // nP
    kb = mesh.shard(keys)
    pos = _positions(mesh, C, kb[0].dtype)
    rank, _, ovf = _exchange_rank_roundtrip(_bootstrap_cols(kb), pos, C)
    del kb
    for t in range(_levels(n1)):
        h = _BOOT << t
        if h >= n1:
            break
        r2 = _shifted_fetch(rank, h, -1)
        rank, distinct, o = _exchange_rank_roundtrip(
            [[r, x] for r, x in zip(rank, r2)], pos, C)
        del r2
        ovf = [a | b for a, b in zip(ovf, o)]
        if int(distinct[0]) == n1:
            break
    # SA: rank is a permutation; deliver pos to the rank's owner slot
    if nP == 1:
        sa = [torch.empty_like(pos[0]).scatter_(0, rank[0].to(torch.int64),
                                                pos[0])]
    else:
        dest = [torch.clamp(r // C, max=nP - 1) for r in rank]
        ones = [torch.ones(C, dtype=torch.bool, device=p.device)
                for p in pos]
        recv, rvalid, o3, _ = _route2([[r, p] for r, p in zip(rank, pos)],
                                      dest, ones, C, C + 2 * nP)
        sa = []
        for m, ((rrank, rpos), v) in enumerate(zip(recv, rvalid)):
            slot = torch.where(v, rrank - m * C, C).to(torch.int64)
            blk = torch.zeros(C + 1, dtype=rpos.dtype, device=rpos.device)
            blk[slot] = rpos
            sa.append(blk[:C])
        ovf = [a | b for a, b in zip(ovf, o3)]
    return sa, int(pmax([o.to(torch.int32) for o in ovf])[0])


def sharded_build_sa_sample_pair(keys, n1: int, mesh: Mesh):
    """The wide lanes: sharded_build_sa_sample over int64 columns, for
    inputs whose positions or key values exceed int32 (the reference's
    (hi, lo) int32 planes hold the same values). Returns (suffix array
    blocks, int64; overflow flag)."""
    return sharded_build_sa_sample(keys.to(torch.int64), n1, mesh)


def sharded_suffix_array(keys, mesh: Mesh, engine: str = "sample",
                         lanes: str | None = None) -> np.ndarray:
    """Host wrapper: pad the keys to a multiple of the mesh size (pad
    keys above every real key, in order, so they take the last slots),
    run the sharded engine and return the unpadded suffix array (numpy).

    engine="sample" (default) is the two-hop sample-sort exchange,
    engine="bitonic" the block-bitonic network (power-of-two meshes);
    an overflow-flagged sample run falls back to the bitonic engine.
    Inputs whose padded length passes 2^30 or whose padded keys reach
    int32's top, and any input with lanes="int64", run the sample engine
    on int64 lanes and return int64; others int32."""
    if engine not in ("sample", "bitonic"):
        raise ValueError(f"unknown engine {engine!r}")
    if lanes not in (None, "int64"):
        raise ValueError(f"unknown lanes {lanes!r}")
    if not isinstance(keys, torch.Tensor):
        keys = torch.from_numpy(np.ascontiguousarray(keys))
    n1 = int(keys.shape[0])
    nP = mesh.size
    npad = max(nP, -(-n1 // nP) * nP)
    kmax = int(keys.max()) if n1 else 0
    wide = (npad > 2 ** 30 or kmax + (npad - n1) >= 2 ** 31 - 1
            or lanes == "int64")
    dt = torch.int64 if wide else torch.int32
    keys = keys.to(dt)
    if npad > n1:
        keys = torch.cat([keys, kmax + 1 + torch.arange(
            npad - n1, dtype=dt, device=keys.device)])
    if wide or (engine == "sample" and nP > 1):
        sa, ovf = sharded_build_sa_sample(keys, npad, mesh)
        if wide:
            assert not ovf, "wide-lane exchange overflow"
        if not ovf:
            return gather(sa)[:n1].cpu().numpy()
    sa = sharded_build_sa(keys, npad, mesh)
    return gather(sa)[:n1].cpu().numpy()
