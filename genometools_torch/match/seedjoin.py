"""seed_extend's seed-pair join as torch ops on the run's device.

The merge-join of two k-mer lists on equal codes (ref:
gt_diagbandseed_merge, src/match/diagbandseed.c:2654), with the native
join's rules (``native/gtnative.cpp`` gt_seed_pair_join2) and its
output: the pairs' (aseq, bseq, bpos, apos) as four int32 planes,
sorted by (aseq, bseq, bpos, apos).

Each list goes up in one copy and is stably sorted by code on the
device; each a entry finds its b range with ``searchsorted``. Ranges of
code groups above maxfreq on either side, and on a self-comparison of
one list the singleton groups, are empty. On a self-comparison of one
list that is sorted by (seq, pos), an entry's range starts after
itself: every pair before it is one the mask rejects. The candidates
expand in one ``repeat_interleave`` (one sync for their count), the mask
keeps a self-comparison's pairs with aseq < bseq, or in one sequence
(inseqseeds) apos + mindist <= bpos <= apos + maxdist, and each pair
packs into one int64 key at the native join's bit widths, aseq highest.
One ``torch.sort`` of the keys is the output order; the planes come
back unpacked in one copy into pinned host memory (PyTorch's pinned
allocator keeps the block for the next call).

``build_seed_pairs`` (``match/seed_extend.py``) routes a CUDA device's
join here; the tests hold this function on the CPU to the native and
the numpy joins.
"""

from __future__ import annotations

import numpy as np
import torch

# the most device bytes a candidate pair holds at once: its a index and
# b index (int64), four int32 fields, the mask, its key and the keys'
# sort; a candidate count whose bytes exceed the card's free memory
# takes the host join
CAND_BYTES = 96


def _bits(maxval: int) -> int:
    """Bits that hold 0..maxval, at least 1 (the native join's
    bits_for)."""
    return max(int(maxval).bit_length(), 1)


def _upload_sorted(lst, device: torch.device):
    """(code, seq, pos) of a k-mer list on the device in one copy,
    stably sorted by code: within a code group, in list order."""
    code, seq, pos = lst
    n = code.size
    buf = torch.empty(4 * n, dtype=torch.int32,
                      pin_memory=device.type == "cuda")
    host = buf.numpy()
    host[:2 * n].view(np.int64)[:] = code
    host[2 * n:3 * n] = seq
    host[3 * n:] = pos
    dev = buf.to(device, non_blocking=True)
    code_s, perm = torch.sort(dev[:2 * n].view(torch.int64), stable=True)
    return code_s, dev[2 * n:3 * n][perm], dev[3 * n:][perm]


def _fits(device: torch.device, total: int) -> bool:
    """Whether `total` candidates fit the device's free memory (the
    allocator's cached blocks count as free); the CPU always fits."""
    if device.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - \
        torch.cuda.memory_allocated(device)
    return total * CAND_BYTES <= free


def seed_pairs_device(alist, blist, selfcomp: bool, maxfreq: int | None,
                      inseqseeds: bool, mindist: int, maxdist: int | None,
                      device):
    """((aseq, bseq, bpos, apos), candidates): the native join's planes
    and order (int32 numpy arrays), and the pairs before the mask; None
    where the packed key (63 bits) or an int32 plane cannot hold the
    lists, or `device`'s free memory the candidates. As in the native
    join, maxfreq None or 0 keeps every group and maxdist None or
    negative bounds nothing."""
    device = torch.device(device)
    acode, aseq, apos = alist
    bcode, bseq, bpos = blist
    same = blist is alist or acode is bcode
    if acode.size == 0 or bcode.size == 0:
        z = np.zeros(0, np.int32)
        return (z, z, z, z), 0
    amax = [int(aseq.max()), int(apos.max())]
    bmax = amax if same else [int(bseq.max()), int(bpos.max())]
    if max(amax + bmax) >= 2 ** 31:
        return None
    f_as, f_bs, f_bp, f_ap = (_bits(amax[0]), _bits(bmax[0]),
                              _bits(bmax[1]), _bits(amax[1]))
    if f_as + f_bs + f_bp + f_ap > 63:
        return None
    sh_bp, sh_bs, sh_as = f_ap, f_ap + f_bp, f_ap + f_bp + f_bs

    ac, as_, ap = _upload_sorted(alist, device)
    bc, bs, bp = (ac, as_, ap) if same else _upload_sorted(blist, device)
    lo = torch.searchsorted(bc, ac)
    hi = torch.searchsorted(bc, ac, right=True)
    bn = hi - lo
    an = bn if same else \
        torch.searchsorted(ac, ac, right=True) - torch.searchsorted(ac, ac)
    keep = torch.ones_like(bn, dtype=torch.bool)
    if maxfreq is not None and maxfreq > 0:
        keep &= (an <= maxfreq) & (bn <= maxfreq)
    if selfcomp and same:
        keep &= an > 1
        if mindist >= 1 or not inseqseeds:
            # in a group sorted by (seq, pos), a pair with an entry at or
            # before its a entry has bs < as, or as == bs and bp <= ap
            up = (as_[1:] > as_[:-1]) | \
                ((as_[1:] == as_[:-1]) & (ap[1:] > ap[:-1]))
            ordered = (up | (ac[1:] != ac[:-1])).all()
            own = torch.arange(1, lo.numel() + 1, device=device)
            lo = torch.where(ordered, own, lo)
    counts = torch.where(keep, hi - lo, 0)
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, np.int32)
        return (z, z, z, z), 0
    if not _fits(device, total):
        return None

    rep = torch.repeat_interleave(counts, output_size=total)
    bidx = torch.arange(total, device=device)
    bidx += (lo - (torch.cumsum(counts, 0) - counts))[rep]
    pa_s, pa_p = as_[rep], ap[rep]
    pb_s, pb_p = bs[bidx], bp[bidx]
    del rep, bidx
    key = pa_s.to(torch.int64) << sh_as
    key |= pb_s.to(torch.int64) << sh_bs
    key |= pb_p.to(torch.int64) << sh_bp
    key |= pa_p.to(torch.int64)
    if selfcomp:
        ok = pa_s < pb_s
        if inseqseeds:
            near = (pa_s == pb_s) & (pb_p - pa_p >= mindist)
            if maxdist is not None and maxdist >= 0:
                near &= pb_p - pa_p <= maxdist
            ok |= near
        del pa_s, pa_p, pb_s, pb_p
        key = key[ok]
        del ok
    else:
        del pa_s, pa_p, pb_s, pb_p
    key = torch.sort(key).values

    n = key.numel()
    out = torch.empty((4, n), dtype=torch.int32, device=device)
    out[0] = key >> sh_as
    out[1] = (key >> sh_bs) & ((1 << f_bs) - 1)
    out[2] = (key >> sh_bp) & ((1 << f_bp) - 1)
    out[3] = key & ((1 << f_ap) - 1)
    del key
    host = torch.empty((4, n), dtype=torch.int32,
                       pin_memory=device.type == "cuda")
    host.copy_(out)
    planes = host.numpy()
    return (planes[0], planes[1], planes[2], planes[3]), total
