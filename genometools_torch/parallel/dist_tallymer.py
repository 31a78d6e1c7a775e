"""Tallymer's k-mer counting over a mesh of devices.

The port of ``genometools_tpu/parallel/dist_tallymer.py``, the
counterpart of the reference's threaded tyr-mkindex counting (ref:
src/match/tyr-mkindex.c; thread model firstcodes.c:506): the window
codes arrive position-sharded, every shard routes each code to the shard
owning its top-bit code range with one ``all_to_all``, and every shard
sorts and run-length counts what it received. Shard d's (mers, counts)
are sorted and disjoint from the others', so their concatenation in
shard order is the sorted mer table.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh, all_to_all

_SENT = 2 ** 31 - 1


def sharded_mer_counts(codes: np.ndarray, k: int, mesh: Mesh):
    """Count the window-code multiset over the mesh. Returns (mers int64
    sorted unique, counts int64), equal to np.unique(codes,
    return_counts=True). The lanes are int32, as the reference's: codes
    must fit 31 bits (k <= 15), wider k raises ValueError."""
    if 2 * k > 30:
        raise ValueError("sharded_mer_counts: k > 15 needs pair lanes")
    nP = mesh.size
    codes = np.asarray(codes)
    n = codes.size
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    m = -(-n // nP)
    flat = torch.full((m * nP,), _SENT, dtype=torch.int32)
    flat[:n] = torch.from_numpy(codes.astype(np.int32))
    # owner by the top bits of the 2k-bit code space
    shift = max(2 * k - max(nP.bit_length() - 1, 0), 0)
    sends = []
    for blk in mesh.shard(flat):
        owner = torch.where(blk >= _SENT, nP - 1, blk >> shift).clamp(
            max=nP - 1)
        dests = torch.arange(nP, device=blk.device)
        sends.append(torch.where(owner[None, :] == dests[:, None],
                                 blk[None, :], _SENT).reshape(-1))
    mers, counts = [], []
    for mine in all_to_all(sends):
        mine = torch.sort(mine).values
        mine = mine[:int((mine < _SENT).sum())]
        u, c = torch.unique_consecutive(mine, return_counts=True)
        mers.append(u.cpu().numpy().astype(np.int64))
        counts.append(c.cpu().numpy().astype(np.int64))
    return np.concatenate(mers), np.concatenate(counts)
