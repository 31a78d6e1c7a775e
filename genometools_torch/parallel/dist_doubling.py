"""Distributed prefix doubling with replicated ranks.

The port of ``genometools_tpu/parallel/dist_doubling.py``, the simpler
cross-check engine beside dist_doubling_sharded: the keys and the
evolving rank array are replicated on every shard's device; each round
every shard takes its position block, routes each (rank, rank[i+h], pos)
triple to the shard owning that rank's value range with one bucketed
``all_to_all`` (send buffers of capacity C = n1/P a pair, so every
shard receives n1 slots), sorts what it received, dense-ranks it with
the boundary stitched from its left neighbour, and the new replicated
rank is one ``psum`` of the shards' scatters.
"""

from __future__ import annotations

import math

import torch

from .dist_doubling_sharded import _BOOT
from .mesh import (Mesh, all_gather, all_to_all, bucket_order, lexsort,
                   ppermute, psum)


def _round(rank: list, h: int, n1: int, mesh: Mesh) -> list:
    """One distributed doubling round; returns the new replicated rank
    (rank: the replicated rank, one tensor a shard)."""
    nP = mesh.size
    C = n1 // nP
    per = -(-n1 // nP)
    planes = [[], [], []]
    for m, r in enumerate(rank):
        dev = r.device
        pos = torch.arange(m * C, (m + 1) * C, device=dev)
        r1 = r[pos]
        r2 = torch.where(pos + h < n1, r[(pos + h).clamp(max=n1 - 1)], -1)
        dest = torch.clamp(r1 // per, max=nP - 1).to(torch.int64)
        order, d_s, starts = bucket_order(dest, nP)
        within = torch.arange(C, device=dev) - starts[d_s]
        for plane, v in zip(planes, (r1, r2, pos.to(r.dtype))):
            buf = torch.full((nP, C), -1, dtype=r.dtype, device=dev)
            buf[d_s, within] = v[order]
            plane.append(buf.reshape(-1))
    fr1, fr2, fp = (all_to_all(p) for p in planes)
    sorted_, lasts, cums = [], [], []
    for m in range(nP):
        # pad slots (rank -1) sort first; ties keep their slot order
        s1, s2, sp = lexsort([fr1[m], fr2[m], fp[m]], 2)
        sorted_.append((s1, s2, sp))
        nvalid = (sp >= 0).sum()
        lasts.append(torch.stack([torch.where(nvalid > 0, s1[-1], -1),
                                  torch.where(nvalid > 0, s2[-1], -1)]))
    prev = ppermute(lasts, [(i, (i + 1) % nP) for i in range(nP)])
    for m, (s1, s2, sp) in enumerate(sorted_):
        M = sp.shape[0]
        sv = sp >= 0
        first_idx = M - sv.sum()              # the first valid slot
        fi = first_idx.clamp(max=M - 1)
        neq = torch.zeros(M, dtype=torch.bool, device=sp.device)
        neq[1:] = (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])
        first_differs = (m == 0) | (s1[fi] != prev[m][0]) | \
            (s2[fi] != prev[m][1])
        neq[0] = False
        neq = torch.where((torch.arange(M, device=sp.device) == first_idx)
                          & sv, first_differs, neq & sv)
        cums.append(torch.cumsum(neq, 0, dtype=s1.dtype))
    totals = all_gather([c[-1] for c in cums])
    contrib = []
    for m, ((s1, s2, sp), c) in enumerate(zip(sorted_, cums)):
        new_sorted = totals[m][:m].sum() + c - 1
        # ranks shifted by one so that pad slots add nothing
        contrib.append(torch.zeros(n1, dtype=s1.dtype, device=s1.device)
                       .scatter_add_(0, sp.clamp(min=0).to(torch.int64),
                                     torch.where(sp >= 0, new_sorted + 1,
                                                 0)))
    return [x - 1 for x in psum(contrib)]


def distributed_build_sa(keys, n1: int, mesh: Mesh) -> torch.Tensor:
    """Replicated-keys, distributed-sort prefix doubling. keys: n1 suffix
    keys, n1 a multiple of the mesh size (pad like
    sharded_suffix_array). Returns the suffix array on the first shard's
    device."""
    nP = mesh.size
    assert n1 % nP == 0
    dev0 = mesh.devices[0]
    keys = torch.as_tensor(keys).to(dev0)
    idx = torch.arange(n1, dtype=keys.dtype, device=dev0)
    ops = [torch.where(idx + j < n1, keys[(idx + j).clamp(max=n1 - 1)], -1)
           for j in range(_BOOT)]
    srt = lexsort(ops + [idx], _BOOT)
    neq0 = torch.zeros(n1, dtype=torch.bool, device=dev0)
    for sk in srt[:_BOOT]:
        neq0[1:] |= sk[1:] != sk[:-1]
    rank = torch.empty_like(idx).scatter_(
        0, srt[-1].to(torch.int64), torch.cumsum(neq0, 0, dtype=idx.dtype))
    levels = max(1, math.ceil(math.log2(max(n1 / _BOOT, 2))))
    rank = mesh.replicate(rank)
    for t in range(levels):
        if n1 <= 1 or int(rank[0].max()) == n1 - 1:
            break
        rank = _round(rank, _BOOT << t, n1, mesh)
    return torch.empty_like(idx).scatter_(0, rank[0].to(torch.int64), idx)
