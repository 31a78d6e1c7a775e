"""K3: single-shot unit-score xdrop extension, one task per lane.

Replaces the Pallas kernel ``genometools_tpu/ops/xdrop_pallas.py``
``_make_kernel`` launched by ``_xdrop_pallas`` / ``xdrop_full_pallas``
(``pl.pallas_call`` at xdrop_pallas.py:301): a whole xdrop extension
(ref: xdrop.c:224-430, match 2, mismatch -1, indel -2, so
EVAL(i+j, d) = i+j-3d) for every task whose flanks fit one W window.
Generation 0 is the first lcp; each generation picks the candidate
row with the DEL > MIS > INS priority, prunes cells more than
belowscore below the best score dback = (belowscore+1)//3+1
generations back, extends taken cells by their match runs and narrows
the live window. A live cell on the slot edge or a lane alive at the
generation cap comes back unsafe.

PK: (N, 6*W/32+2) int32 holding uint32 bit patterns — the six planes
of the U and V windows, then ulen, vlen. Result: (4, N) int32 — best
ivalue, jvalue, score, unsafe.

On the card (csrc/xdrop_full.cu) a task is one warp with its slots
spread over the threads, as K1. Slot s holds diagonal kk = s - D with
j = i - kk, so the shared match words are read on diagonal -kk (the
TPU kernel flips the slot axis of the greedy bitmask instead).

The plain version is lane-vectorised over (N, K) with a Python
generation loop, for CPU tests and for checking the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from .bits import from_i32_bits
from .pool import pack_codes
from .greedy_full import gens_cap, match_run, match_words

NEGINF = -(2 ** 30)

launches = 0        # kernel launches (the CUDA path only)


def _run_extend(M: torch.Tensor, row: torch.Tensor, valid: torch.Tensor,
                W: int) -> torch.Tensor:
    """Advance row by the match run on its slot's diagonal."""
    return row + match_run(M, row, valid & (row >= 0) & (row < W))


def xdrop_full_plain(PK: torch.Tensor, belowscore: int, W: int, D: int,
                     GENS: int, counts: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of K3 (same inputs and (4, N) result).
    counts, when a dict, gains under "slot_gens" the candidate slots
    (lb-1 .. ub+1) summed over every lane's generations (the work the
    data needs, for the kernel's operation bound)."""
    dev = PK.device
    N = PK.shape[0]
    W32 = W // 32
    K = 2 * D + 1
    dback = (belowscore + 1) // 3 + 1
    P = from_i32_bits(PK[:, :6 * W32]).reshape(N, 6, W32)
    ulen = PK[:, 6 * W32:6 * W32 + 1].to(torch.int64)
    vlen = PK[:, 6 * W32 + 1:6 * W32 + 2].to(torch.int64)
    # slot s reads diagonal -(s - D): flip the greedy slot order
    M = match_words(P, W, D).flip(1)
    sidx = torch.arange(K, device=dev).view(1, K)
    kk = sidx - D

    def first(mask):
        return torch.where(mask, sidx, K).amin(dim=1, keepdim=True)

    def take(a, idx):
        return torch.gather(a, 1, idx.clamp(0, K - 1))

    center = (sidx == D).expand(N, K)
    row0 = _run_extend(M, torch.where(center, 0, NEGINF).to(torch.int64),
                       center, W)
    init_lcp = row0[:, D:D + 1]
    finished0 = (init_lcp >= ulen) | (init_lcp >= vlen)
    lb = torch.where(finished0, 1, 0)
    ub = torch.where(finished0, -1, 0)
    row = torch.where(center, init_lcp, NEGINF)
    best_i, best_j, best_s = init_lcp, init_lcp, 2 * init_lcp
    btq = best_s.expand(N, dback).clone()
    unsafe = torch.zeros(N, 1, dtype=torch.bool, device=dev)
    neg = torch.full((N, 1), NEGINF, dtype=torch.int64, device=dev)

    for d in range(1, gens_cap(GENS) + 1):
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
        pruned = (d > dback) & has & (i_new + j_new - 3 * d <
                                      tref - belowscore)
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

        j_ext = i_ext - kk
        sc = torch.where(takes & active, i_ext + j_ext - 3 * d, NEGINF)
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
        edge = (has_row & ((sidx == 0) | (sidx == K - 1))) \
            .any(dim=1, keepdim=True)
        unsafe = unsafe | (active & edge)
        stop = done_align | ~any_row | edge
        lb = torch.where(active, torch.where(stop, 1, new_lb), lb)
        ub = torch.where(active, torch.where(stop, -1, new_ub), ub)
        row = new_row
    unsafe = unsafe | (lb <= ub)
    out = torch.cat([best_i, best_j, best_s, unsafe.to(torch.int64)], dim=1)
    return out.T.contiguous().to(torch.int32)


def xdrop_full(PK: torch.Tensor, belowscore: int, W: int, D: int = 32,
               GENS: int = 512) -> torch.Tensor:
    """K3 on PK's device: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. Returns (4, N) int32 on that device."""
    global launches
    W32 = W // 32
    if W % 32 or W <= 0 or not 1 <= D <= 143 or GENS < 0:
        raise ValueError(f"unsupported shape W={W} D={D} GENS={GENS}")
    if not 0 <= belowscore <= 188:
        raise ValueError(f"belowscore {belowscore} out of range [0, 188]")
    if PK.dim() != 2 or PK.shape[1] != 6 * W32 + 2:
        raise ValueError(f"PK must be (N, {6 * W32 + 2}), got "
                         f"{tuple(PK.shape)}")
    if PK.dtype != torch.int32:
        raise TypeError(f"PK must be int32 bit patterns, got {PK.dtype}")
    if PK.device.type == "cpu":
        return xdrop_full_plain(PK, belowscore, W, D, GENS)
    if PK.device.type != "cuda":
        raise ValueError(f"unsupported device {PK.device}")
    if not PK.is_contiguous():
        raise ValueError("PK must be contiguous")
    N = PK.shape[0]
    out = torch.empty((4, N), dtype=torch.int32, device=PK.device)
    if N == 0:
        return out
    L = _kernels.lib()
    err = L.gt_xdrop_full(PK.data_ptr(), out.data_ptr(), N, W, D,
                          gens_cap(GENS), int(belowscore),
                          _kernels.stream_ptr(PK.device))
    _kernels.check(err, "gt_xdrop_full")
    launches += 1
    return out


def pack_xdrop_tasks(us, vs, W: int) -> np.ndarray:
    """Host packing: (N, 6*W/32+2) uint32 for xdrop_full — the planes of
    the 255-padded U and V windows plus ulen/vlen columns."""
    N = len(us)
    U = np.full((N, W), 255, np.uint8)
    V = np.full((N, W), 255, np.uint8)
    for i, (u, v) in enumerate(zip(us, vs)):
        U[i, :len(u)] = u
        V[i, :len(v)] = v
    ulen = np.fromiter((len(u) for u in us), np.uint32, N)
    vlen = np.fromiter((len(v) for v in vs), np.uint32, N)
    return np.concatenate([*pack_codes(U), *pack_codes(V), ulen[:, None],
                           vlen[:, None]], axis=1).astype(np.uint32)
