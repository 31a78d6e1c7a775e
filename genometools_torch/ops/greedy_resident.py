"""The resident K2: long greedy extensions from generation 0 to the end
in one launch.

A redesign of K2 (``ops/greedy_chunk.py``; the TPU kernel is
``genometools_tpu/ops/greedy_pallas.py`` ``_make_kernel(single_shot=
False)``, ``pl.pallas_call`` at greedy_pallas.py:456) together with its
windowed chunk loop (the reference's greedy_batch.py:688-868,
``ops/chunk_loop.py`` here). The TPU design pauses every lane after each
chunk and rebases its window on the host, because a TPU kernel could
not gather from the pool or rebase itself. On the H100
(``csrc/greedy_resident.cu``) one warp takes a lane from a work queue
(lanes longest first) and keeps it until it is done:

1. generation 0: the seed's first match run, read from the pool's
   planes (``resident_gen0_plain`` is its twin);
2. each chunk: the W-symbol window read from the pool into shared
   memory (``pool_windows_plain`` is its twin), up to GENS generations
   of K2's recurrence, then the rebase with ``chunk_loop.rebase``'s
   rules, all in registers and warp reductions;
3. a lane writes only best[4], died, its route and its chunks. A lane
   that the rules give up on, or that runs ``max_chunks`` chunks, falls
   back (to the host engine).

Shared memory holds one window of the widest tier per warp, so the
kernel holds every window tier: on the H100 the registers, not the
window, set its occupancy (PERF.md).

Result (dict of tensors on the pool's device): per lane best (N, 4)
int32, died bool, route int8 (chunk_loop's DONE or FALLBACK), chunks
int32; and slot_gens (1,) int64, the live slot-generations of all lanes
(the work the data needs).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _kernels
from .bits import M32, ctz32
from .chunk_loop import chunk_loop
from .greedy_chunk import greedy_chunk_plain
from .greedy_full import check_history, gens_cap
from .pool import (check_lanes, gen0_state, kernel_occupancy,
                   pool_windows_plain, seed_history)

MAX_D = 64          # the kernel keeps at most 5 slot groups (K <= 160)

launches = 0        # kernel launches (the CUDA path only)
# the work of those launches, for the kernel's bound: live
# slot-generations, and bytes moved (pool planes, lane descriptors and
# outputs, each once)
work = {"slot_gens": 0, "bytes": 0}


def resident_gen0_plain(gp: torch.Tensor, ustart, ulen, vstart, vlen, rev,
                        seedlen, hist_cap: int):
    """Generation 0 as the kernel computes it: the first match run c0
    (int64), found 1,024 symbols (one word a thread) at a time from the
    pool, and the centre slot's history h0 (int64 bit patterns) and
    hsize hs0. Equals chunk_gen0."""
    n = ustart.numel()
    c0 = torch.zeros(n, dtype=torch.int64, device=gp.device)
    live = torch.ones(n, dtype=torch.bool, device=gp.device)
    while bool(live.any()):
        i = live.nonzero().view(-1)
        c = c0[i]
        P = pool_windows_plain(gp, ustart[i], ulen[i], vstart[i], vlen[i],
                               rev[i], c, c, 1024).to(torch.int64) & M32
        P = P.view(-1, 6, 32)
        m = ~(P[:, 0] ^ P[:, 3]) & ~(P[:, 1] ^ P[:, 4]) & ~P[:, 2] & \
            ~P[:, 5] & M32
        notfull = m != M32
        first = torch.where(notfull, torch.arange(32, device=gp.device),
                            32).amin(dim=1)
        mf = torch.gather(m, 1, first.clamp(max=31).view(-1, 1)).view(-1)
        stop = first < 32
        c0[i] = c + torch.where(stop, 32 * first + ctz32(~mf & M32), 1024)
        live[i[stop]] = False
    h0, hs0 = seed_history(seedlen.cpu().numpy(), c0.cpu().numpy(),
                           hist_cap)
    return (c0, torch.from_numpy(h0).to(gp.device),
            torch.from_numpy(hs0).to(gp.device, torch.int32))


def greedy_resident_plain(gp: torch.Tensor, ustart, ulen, vstart, vlen,
                          rev, seedlen, mmp128: int, mad: int,
                          match_score: int, difference_score: int,
                          hist_cap: int, w_tiers, d_tiers, GENS: int,
                          max_chunks: int, counts: dict | None = None) -> dict:
    """Plain PyTorch version of the resident kernel (same inputs and
    result): generation 0 and the pool windows from the twins above,
    then the chunk loop's rules with K2's plain version. counts: see
    greedy_full.front_plain (the live slot-generations); its "chunks"
    gains the lane-chunks run at each (W, D)."""
    dev = gp.device
    n = ustart.numel()
    counts = {} if counts is None else counts
    gens0 = counts.get("slot_gens", 0)
    c0, h0, hs0 = resident_gen0_plain(gp, ustart, ulen, vstart, vlen, rev,
                                      seedlen, hist_cap)

    def chunk_fn(*a):
        by = counts.setdefault("chunks", {})
        by[a[-3:-1]] = by.get(a[-3:-1], 0) + a[0].shape[0]
        return greedy_chunk_plain(*a, counts=counts)

    out = chunk_loop(gp, (ustart, ulen, vstart, vlen, rev),
                     (mmp128, mad, match_score, difference_score, hist_cap),
                     c0.cpu().numpy(), gen0_state(h0, hs0, d_tiers[-1]),
                     chunk_fn, pool_windows_plain, w_tiers, d_tiers, GENS,
                     max_chunks, max(n, 1))

    def t(a, dtype=None):
        return torch.from_numpy(np.asarray(a)).to(dev, dtype)
    return {"best": t(out["best"], torch.int32), "died": t(out["died"]),
            "route": t(out["route"]), "chunks": t(out["chunks"], torch.int32),
            "slot_gens": t([counts.get("slot_gens", 0) - gens0])}


def _check(gp, desc, w_tiers, d_tiers, GENS, max_chunks):
    check_lanes(gp, desc)
    if not 1 <= len(w_tiers) <= 4 or not 1 <= len(d_tiers) <= 4 or \
            any(W % 32 or W <= 0 for W in w_tiers) or \
            any(not 1 <= D <= MAX_D for D in d_tiers) or \
            list(w_tiers) != sorted(set(w_tiers)) or \
            list(d_tiers) != sorted(d_tiers):
        raise ValueError(f"unsupported tiers {w_tiers} {d_tiers}")
    if GENS < 0 or max_chunks < 1:
        raise ValueError(f"unsupported GENS={GENS} max_chunks={max_chunks}")


def resident_occupancy(wmax: int) -> dict:
    """The kernel's occupancy on the current card with windows of up to
    wmax symbols: resident warps per SM, registers a thread, SMs."""
    return kernel_occupancy("gt_greedy_resident_occupancy", wmax)


def greedy_resident(gp: torch.Tensor, ustart, ulen, vstart, vlen, rev,
                    seedlen, mmp128: int, mad: int, match_score: int,
                    difference_score: int, hist_cap: int, w_tiers, d_tiers,
                    GENS: int, max_chunks: int) -> dict:
    """The resident kernel on the pool's device: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. Returns the result
    described in the module docstring."""
    check_history(hist_cap)
    desc = (ustart, ulen, vstart, vlen, rev, seedlen)
    _check(gp, desc, w_tiers, d_tiers, GENS, max_chunks)
    sc = (int(mmp128), int(mad), int(match_score), int(difference_score),
          int(hist_cap))
    if gp.device.type == "cpu":
        return greedy_resident_plain(gp, *desc, *sc, w_tiers, d_tiers, GENS,
                                     max_chunks)
    if gp.device.type != "cuda":
        raise ValueError(f"unsupported device {gp.device}")
    dev = gp.device
    n = ustart.numel()
    i32 = dict(dtype=torch.int32, device=dev)
    gp = gp.contiguous()
    desc = tuple(t.contiguous() for t in desc)
    # the work queue: longest lanes first, so the launch's tail is short
    order = torch.argsort(ulen + vlen, descending=True,
                          stable=True).to(torch.int32)
    ctr = torch.zeros(1, **i32)
    best = torch.empty((n, 4), **i32)
    died = torch.empty(n, dtype=torch.bool, device=dev)
    route = torch.empty(n, dtype=torch.int8, device=dev)
    chunks = torch.empty(n, **i32)
    slot_gens = torch.zeros(1, dtype=torch.int64, device=dev)
    conf = [len(w_tiers), *w_tiers, *[0] * (4 - len(w_tiers)),
            len(d_tiers), *d_tiers, *[0] * (4 - len(d_tiers)),
            gens_cap(GENS), int(max_chunks), 15, *sc]
    conf_c = (ctypes.c_int * len(conf))(*conf)
    if n:
        _kernels.call(
            "gt_greedy_resident", dev, gp.data_ptr(), gp.shape[1], *(t.data_ptr() for t in desc),
            order.data_ptr(), ctr.data_ptr(), best.data_ptr(),
            died.data_ptr(), route.data_ptr(), chunks.data_ptr(),
            slot_gens.data_ptr(), conf_c, n)
        # 41 bytes in and 22 out a lane
        _kernels.record_launch(globals(), int(slot_gens),
                               gp.numel() * 8 + 63 * n)
    return {"best": best, "died": died, "route": route, "chunks": chunks,
            "slot_gens": slot_gens}
