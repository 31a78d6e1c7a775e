"""Readjoiner's overlap candidates counted over a mesh of devices.

The port of ``genometools_tpu/parallel/dist_readjoiner.py``, the
firstcodes counterpart (ref: src/match/firstcodes.c:1517 parts): the
suffix-window positions of the mirrored read set are sharded over the
mesh; every shard holds the read blob and the sorted read-prefix codes,
computes its windows' codes and counts their candidate matches with two
``searchsorted``, reduced with one ``psum``. The count sizes the
emission stage, the native window-scan join (native/gtnative.cpp
gt_spm_find) over contiguous read ranges: it chooses the join's lane
count, and the join's rows do not depend on it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .mesh import Mesh, psum


def _mirrored(readset):
    """(blob, starts, lens) of the mirrored read list (forward reads,
    then their reverse complements in reverse order), find_spms's
    numbering."""
    lens = np.concatenate([readset.lens, readset.lens[::-1]])
    blob = np.concatenate([readset.blob,
                           (3 - readset.blob[::-1]).astype(np.uint8)])
    return blob, np.cumsum(lens) - lens, lens


def _window_codes(blob: torch.Tensor, lo: int, hi: int, k: int):
    """Codes of the k-windows starting at lo..hi-1 (2 bits a symbol)."""
    code = torch.zeros(hi - lo, dtype=torch.int64, device=blob.device)
    for j in range(k):
        code = code * 4 + blob[lo + j:hi + j]
    return code


def sharded_spm_candidate_count(readset, minlen: int, mesh: Mesh) -> int:
    """Pass A: the (suffix window, read prefix) code collisions of the
    mirrored read set, counted with the window positions sharded over
    the mesh (ref: firstcodes.c gt_firstcodes_accumulatecounts). A
    window counts when it starts at least minlen before its read's end."""
    if readset.num_reads == 0:
        return 0
    k = min(minlen, 31)
    blob, starts, lens = _mirrored(readset)
    total = int(blob.size)
    if total < k:
        return 0
    npos = total - k + 1
    per = -(-npos // mesh.size)
    blobs = mesh.replicate(torch.from_numpy(blob).to(torch.int64))
    # the sorted codes of the read prefixes (reads of k or more)
    first = torch.from_numpy(starts[lens >= k]).to(mesh.devices[0])
    pref = torch.sort((blobs[0][first[:, None] + torch.arange(
        k, device=first.device)] * 4 ** torch.arange(
            k - 1, -1, -1, device=first.device)).sum(1)).values
    ends_h = torch.from_numpy(starts + lens)
    counts = []
    for m, (dev, b) in enumerate(zip(mesh.devices, blobs)):
        lo, hi = min(npos, m * per), min(npos, (m + 1) * per)
        code = _window_codes(b, lo, hi, k)
        pos = torch.arange(lo, hi, device=dev)
        ends = ends_h.to(dev)
        read_end = ends[torch.searchsorted(ends, pos, right=True)
                        .clamp(max=ends.numel() - 1)]
        p = pref.to(dev)
        hit = torch.searchsorted(p, code, right=True) - \
            torch.searchsorted(p, code)
        counts.append(torch.where(read_end - pos >= minlen, hit, 0).sum())
    return int(psum(counts)[0])


def distributed_find_spms(readset, minlen: int, mesh: Mesh,
                          irreducible: bool = True):
    """Counting-informed overlap: pass A on the mesh sizes the workload
    (candidate count -> the join's lane count), pass B is
    assembly.readjoiner.find_spms with that many lanes; its output is
    find_spms's (the reference's part-count invariance)."""
    from ..assembly.readjoiner import find_spms
    candidates = sharded_spm_candidate_count(readset, minlen, mesh)
    lanes = max(1, min(mesh.size, os.cpu_count() or 1,
                       1 + candidates // 4096))
    return find_spms(readset, minlen, irreducible=irreducible, lanes=lanes)
