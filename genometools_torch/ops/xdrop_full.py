"""K3: single-shot unit-score xdrop extension, one task per lane.

Replaces the Pallas kernel ``genometools_tpu/ops/xdrop_pallas.py``
``_make_kernel`` launched by ``_xdrop_pallas`` / ``xdrop_full_pallas``
(``pl.pallas_call`` at xdrop_pallas.py:301): a whole xdrop extension
(ref: xdrop.c:224-430) for scores whose unit distances are (1, 1, 1)
(``XdropScores.distances()``): EVAL(i+j, d) = half*(i+j) - quantum*d,
with quantum 3 and half 1 for seed_extend's match 2, mismatch -1, indel
-2 and quantum 4, half 1 for ltrharvest's 2, -2, -3. Generation 0 is
the first lcp; each generation picks the candidate row with the
DEL > MIS > INS priority, prunes cells more than belowscore below the
best score dback = (belowscore+half)//quantum+1 generations back,
extends taken cells by their match runs and narrows the live window.

Input: the uploaded pool (``ops/pool.py``) and per lane ustart, ulen,
vstart, vlen, rev; window tiers ((W, GENS), ...). A lane runs in a
window of its flanks clipped at the tier's W, with the true flank
lengths in every test, for at most GENS generations. It comes back
unsafe when its front reaches the slot edge (``EDGE``), when a taken
cell's match run reaches the clip of a flank that goes on (``CLIP``:
the run might go on), or when it is alive at the cap (``CAP``); the last
two run again at the next tier. The TPU design sent lanes longer than
its widest window, and lanes whose end diagonal lies outside the band,
to the host instead: here a flank is clipped, and a cell leaves the
band only through an edge slot. Result: (5, N) int32 (best ivalue,
jvalue, score, unsafe, the last tier run) and the candidate
slot-generations of the run.

On the card (csrc/xdrop_full.cu) warps persist and take lanes from a
queue, longest first; a lane is one warp with its slots spread over the
threads, as K1. Slot s holds diagonal kk = s - D with j = i - kk, so the
shared match words are read on diagonal -kk (the TPU kernel flips the
slot axis of the greedy bitmask instead).

The plain version is lane-vectorised over (N, K) with a Python
generation loop, for CPU tests and for checking the kernel.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .bits import NEGINF
from .greedy_full import gens_cap, match_run, match_words
from .pool import (check_lanes, kernel_occupancy, launch_pool_kernel,
                   window_planes)

SAFE, EDGE, CAP, CLIP = 0, 1, 2, 3       # why a lane is unsafe
MAX_TIERS = 4
RING_MAX = 64       # the kernel's score ring: dback <= 64

launches = 0        # kernel launches (the CUDA path only)
# the work of those launches, for the kernel's bound: candidate
# slot-generations, and bytes moved (pool planes, lane descriptors and
# outputs, each once)
work = {"slot_gens": 0, "bytes": 0}


def _run_extend(M: torch.Tensor, row: torch.Tensor, valid: torch.Tensor,
                W: int) -> torch.Tensor:
    """Advance row by the match run on its slot's diagonal."""
    return row + match_run(M, row, valid & (row >= 0) & (row < W))


def _xdrop_window(P: torch.Tensor, ulen: torch.Tensor, vlen: torch.Tensor,
                  belowscore: int, quantum: int, half: int, W: int, D: int,
                  gcap: int, counts: dict | None):
    """One tier: the lanes' best (i, j, score) and reason, each (n, 1),
    in windows P (n, 6, W/32) of flanks of ulen, vlen (n, 1) symbols."""
    dev = P.device
    N = P.shape[0]
    K = 2 * D + 1
    dback = (belowscore + half) // quantum + 1
    # slot s reads diagonal -(s - D): flip the greedy slot order
    M = match_words(P, W, D).flip(1)
    sidx = torch.arange(K, device=dev).view(1, K)
    kk = sidx - D
    uclip, vclip = ulen > W, vlen > W

    def first(mask):
        return torch.where(mask, sidx, K).amin(dim=1, keepdim=True)

    def take(a, idx):
        return torch.gather(a, 1, idx.clamp(0, K - 1))

    center = (sidx == D).expand(N, K)
    row0 = _run_extend(M, torch.where(center, 0, NEGINF).to(torch.int64),
                       center, W)
    init_lcp = row0[:, D:D + 1]
    clip0 = (uclip | vclip) & (init_lcp >= W)
    finished0 = (init_lcp >= ulen) | (init_lcp >= vlen) | clip0
    lb = torch.where(finished0, 1, 0)
    ub = torch.where(finished0, -1, 0)
    row = torch.where(center, init_lcp, NEGINF)
    best_i, best_j, best_s = init_lcp, init_lcp, 2 * half * init_lcp
    btq = best_s.expand(N, dback).clone()
    reason = torch.where(clip0, CLIP, SAFE)
    neg = torch.full((N, 1), NEGINF, dtype=torch.int64, device=dev)

    for d in range(1, gcap + 1):
        active = lb <= ub
        if not bool(active.any()):
            break
        if counts is not None:
            counts["slot_gens"] = counts.get("slot_gens", 0) + \
                int(torch.where(active, ub - lb + 3, 0).sum())
        dd = d - 1
        del_row = torch.cat([neg, row[:, :-1]], dim=1)         # row[k-1]
        ins_row = torch.cat([row[:, 1:], neg], dim=1)          # row[k+1]
        in_prev = (kk >= -dd) & (kk <= dd)
        in_prev_m1 = (kk - 1 >= -dd) & (kk - 1 <= dd)
        in_prev_p1 = (kk + 1 >= -dd) & (kk + 1 <= dd)
        cand_del = torch.where((lb < kk) & in_prev_m1, del_row + 1, NEGINF)
        cand_mis = torch.where((lb <= kk) & (kk <= ub) & in_prev, row + 1,
                               NEGINF)
        cand_ins = torch.where((kk < ub) & in_prev_p1, ins_row, NEGINF)
        i_new = cand_del
        i_new = torch.where(cand_mis > i_new, cand_mis, i_new)
        i_new = torch.where(cand_ins > i_new, cand_ins, i_new)
        i_new = torch.where((lb - 1 <= kk) & (kk <= ub + 1), i_new, NEGINF)
        has = i_new >= 0
        j_new = i_new - kk
        tref = btq[:, 0:1]
        pruned = (d > dback) & has & (half * (i_new + j_new) - quantum * d
                                      < tref - belowscore)
        i_new = torch.where(pruned, NEGINF, i_new)
        has = i_new >= 0
        minuv = torch.minimum(ulen, vlen + kk)
        cond_edge = (kk <= -d) | (kk >= d)
        cond_mid = (row < i_new) & (i_new <= minuv)
        takes = has & (cond_edge | cond_mid)
        keeps = has & ~takes
        can_ext = takes & (i_new < ulen) & (i_new - kk < vlen)
        i_ext = _run_extend(M, torch.where(can_ext, i_new, NEGINF), can_ext,
                            W)
        i_ext = torch.where(can_ext, i_ext, i_new)
        new_row = torch.where(takes, i_ext,
                              torch.where(keeps, row, NEGINF))
        new_row = torch.where(active, new_row, row)
        # a run that reaches the clip of a flank that goes on
        clip = (can_ext & ((uclip & (i_ext >= W)) |
                           (vclip & (i_ext - kk >= W)))) \
            .any(dim=1, keepdim=True)

        j_ext = i_ext - kk
        sc = torch.where(takes & active,
                         half * (i_ext + j_ext) - quantum * d, NEGINF)
        scbest = sc.amax(dim=1, keepdim=True)
        fidx = first(sc == scbest)
        better = scbest > best_s
        best_i = torch.where(better, take(i_ext, fidx), best_i)
        best_j = torch.where(better, take(j_ext, fidx), best_j)
        best_s = torch.where(better, scbest, best_s)
        btq = torch.cat([btq[:, 1:], best_s], dim=1)

        end_k = ulen - vlen
        eidx = (end_k + D).clamp(0, K - 1)
        done_align = (end_k.abs() <= min(d, D)) & \
            (take(new_row, eidx) == ulen)
        has_row = new_row > NEGINF
        first_k = first(has_row)
        last_k = torch.where(has_row, sidx, -1).amax(dim=1, keepdim=True)
        any_row = last_k >= 0
        new_lb = torch.where(any_row, first_k - D, 1)
        new_ub = torch.where(any_row, last_k - D, -1)
        hit_v = has_row & (new_row == vlen + kk) & (kk <= 0) & (kk >= new_lb)
        kv = torch.where(hit_v, sidx, -1).amax(dim=1, keepdim=True)
        new_lb = torch.where(kv >= 0, torch.maximum(new_lb, kv - D), new_lb)
        hit_u = has_row & (new_row == ulen) & (kk >= 0) & (kk <= new_ub)
        ku = first(hit_u)
        new_ub = torch.where(ku < K, torch.minimum(new_ub, ku - D), new_ub)
        edge = any_row & ((first_k == 0) | (last_k == K - 1))
        reason = torch.where(active & clip, CLIP,
                             torch.where(active & edge, EDGE, reason))
        stop = done_align | ~any_row | edge | clip
        lb = torch.where(active, torch.where(stop, 1, new_lb), lb)
        ub = torch.where(active, torch.where(stop, -1, new_ub), ub)
        row = new_row
    # a lane still alive at the generation cap is unverified too
    reason = torch.where((reason == SAFE) & (lb <= ub), CAP, reason)
    return best_i, best_j, best_s, reason


def xdrop_full_plain(gp: torch.Tensor, ustart, ulen, vstart, vlen, rev,
                     belowscore: int, tiers, D: int,
                     counts: dict | None = None, quantum: int = 3,
                     half: int = 1) -> torch.Tensor:
    """Plain PyTorch version of K3 (same inputs and (5, N) result); every
    lane's window at a tier is the tier's W (the kernel rounds a lane's
    flanks up to 32 within it: the same result). counts, when a dict,
    gains under "slot_gens" the candidate slots (lb-1 .. ub+1) summed
    over every lane's generations at every tier it ran (the work the
    data needs, for the kernel's operation bound)."""
    N = ustart.numel()
    out = torch.zeros((5, N), dtype=torch.int64, device=gp.device)
    todo = torch.arange(N, device=gp.device)
    for t, (W, GENS) in enumerate(tiers):
        if todo.numel() == 0:
            break
        P = window_planes(gp, ustart[todo], ulen[todo], vstart[todo],
                          vlen[todo], rev[todo], W)
        bi, bj, bs, reason = _xdrop_window(
            P, ulen[todo].view(-1, 1), vlen[todo].view(-1, 1), belowscore,
            quantum, half, W, D, gens_cap(GENS), counts)
        out[:, todo] = torch.cat([bi, bj, bs, (reason != SAFE).long(),
                                  torch.full_like(bi, t)], dim=1).T
        retry = ((reason == CLIP) | (reason == CAP)).view(-1)
        todo = todo[retry] if t + 1 < len(tiers) else todo[:0]
    return out.to(torch.int32)


def max_belowscore(quantum: int = 3, half: int = 1) -> int:
    """The largest belowscore whose dback fits the kernel's ring."""
    return RING_MAX * quantum - half - 1


def _check_tiers(tiers, D, belowscore, quantum=3, half=1):
    if not 1 <= len(tiers) <= MAX_TIERS or not 1 <= D <= 143 or \
            any(W % 32 or W <= 0 or G < 0 for W, G in tiers) or \
            [W for W, _ in tiers] != sorted(W for W, _ in tiers):
        raise ValueError(f"unsupported tiers {tiers} D={D}")
    if quantum < 1 or half < 1:
        raise ValueError(f"unsupported quantum {quantum}, half {half}")
    top = max_belowscore(quantum, half)
    if not 0 <= belowscore <= top:
        raise ValueError(f"belowscore {belowscore} out of range [0, {top}] "
                         f"at quantum {quantum}, half {half}")


def _conf(tiers, D: int, belowscore: int, quantum: int = 3,
          half: int = 1) -> list:
    pad = [0] * (MAX_TIERS - len(tiers))
    return [len(tiers), *(W for W, _ in tiers), *pad,
            *(gens_cap(G) for _, G in tiers), *pad, D, belowscore, quantum,
            half]


def xdrop_full(gp: torch.Tensor, ustart, ulen, vstart, vlen, rev,
               belowscore: int, tiers, D: int = 32, quantum: int = 3,
               half: int = 1):
    """K3 on the pool's device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. The score is half*(i+j) - quantum*d
    (``XdropScores.distances()`` of unit-distance scores). Returns the
    (5, N) int32 result and the candidate slot-generations, (1,) int64,
    both on that device."""
    tiers = tuple((int(W), int(G)) for W, G in tiers)
    _check_tiers(tiers, D, belowscore, quantum, half)
    desc = (ustart, ulen, vstart, vlen, rev)
    check_lanes(gp, desc)
    if gp.device.type == "cpu":
        cnt = {}
        out = xdrop_full_plain(gp, *desc, belowscore, tiers, D, counts=cnt,
                               quantum=quantum, half=half)
        return out, torch.tensor([cnt.get("slot_gens", 0)])
    if gp.device.type != "cuda":
        raise ValueError(f"unsupported device {gp.device}")
    N = ustart.numel()
    out = torch.empty((5, N), dtype=torch.int32, device=gp.device)
    if N == 0:
        return out, torch.zeros(1, dtype=torch.int64, device=gp.device)
    slot_gens = launch_pool_kernel("gt_xdrop_full", gp, desc,
                                   _conf(tiers, D, belowscore, quantum,
                                         half), out)
    _kernels.record_launch(globals(), int(slot_gens),
                           gp.numel() * 8 + 33 * N + out.numel() * 4)
    return out, slot_gens


def occupancy(tiers, D: int = 32) -> dict:
    """The kernel's occupancy on the current card for these window tiers:
    resident warps per SM, registers a thread, SMs."""
    return kernel_occupancy("gt_xdrop_full_occupancy", _conf(tiers, D, 7))
