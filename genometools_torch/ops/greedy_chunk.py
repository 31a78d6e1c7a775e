"""K2: resumable greedy front-prune chunk, one task per lane.

Replaces the Pallas kernel ``genometools_tpu/ops/greedy_pallas.py``
``_make_kernel(single_shot=False)`` launched by ``_chunk_pallas`` /
``greedy_chunk_pallas`` (``pl.pallas_call`` at greedy_pallas.py:456);
its XLA twin is ``genometools_tpu/ops/greedy_batch.py``
``greedy_chunk_xla``. K2 runs K1's generation body on a state that the
windowed chunk loop (``ops/chunk_loop.py``) carries across chunks: it
scores the input state (trim, polished point, completion — idempotent,
so a raw generation-0 state is fine and no generation 0 runs here),
runs up to GENS generations, and pauses a lane whose front touches the
window end (urem > W or vrem > W) or the slot edge, rolling that
generation back, so the host can rebase the window and resume.

Inputs: P (N, 6*W/32) int32 holding the uint32 lo, hi and special
bit-planes of the U and V windows (u[du:du+W], v[dv:dv+W]); per slot
(N, K) with K = 2D+1: row, hsize, mm int32, h int64 (the 64-bit match
history's bits), valid bool; per lane (N,): d_lane int32, done and
died bool, best (N, 4) int32 (alignedlen, row, distance, mismatches),
urem, vrem, kbase (= dv - du) and rowbase (= du) int32. Rows and
diagonals are window-relative, alignedlen absolute. The result is the
reference's 11-part state with the history in one int64 column:
(row, h, hsize, mm, valid, best, done, died, paused, d_lane).

On the card (csrc/greedy_chunk.cu) a task is one warp, as in K1: the
slot state is loaded from device memory into registers, the window
planes into shared memory, the match words are computed from the
planes on the fly (the TPU kernel's (W/32, K, N) match bitmask, 396 KB
a lane at W=24,576, D=64, is never built), and the whole state is
stored back. The plain version below shares K1's lane-vectorised
recurrence (``greedy_full.front_plain``).
"""

from __future__ import annotations

import torch

from .. import _kernels
from .bits import M32, from_i32_bits
from .greedy_full import check_history, front_plain, gens_cap

launches = 0        # kernel launches (the CUDA path only)


def greedy_chunk_plain(P, row, h, hsize, mm, valid, d_lane, done, died,
                       best, urem, vrem, kbase, rowbase, mmp128: int,
                       mad: int, match_score: int, difference_score: int,
                       hist_cap: int, W: int, D: int, GENS: int,
                       cut_depth: int = 15, counts: dict | None = None):
    """Plain PyTorch version of K2 (same inputs and result); counts: see
    greedy_full.front_plain."""
    N = P.shape[0]
    i64 = torch.int64

    def col(a):
        return a.to(i64).view(N, 1)

    h = h.to(i64)
    st = dict(row=row.to(i64), hlo=h & M32, hhi=(h >> 32) & M32,
              hs=hsize.to(i64), mm=mm.to(i64), valid=valid.to(torch.bool),
              d_lane=col(d_lane), done=col(done) != 0, died=col(died) != 0,
              urem=col(urem), vrem=col(vrem), kbase=col(kbase),
              rowbase=col(rowbase),
              best=[best[:, i].to(i64).view(N, 1) for i in range(4)])
    f = front_plain(from_i32_bits(P).reshape(N, 6, W // 32), st,
                    (mmp128, mad, match_score, difference_score, hist_cap,
                     cut_depth), W, D, GENS, False, counts)
    i32 = torch.int32
    return (f["row"].to(i32), f["hlo"] | (f["hhi"] << 32),
            f["hs"].to(i32), f["mm"].to(i32), f["valid"],
            torch.cat(f["best"], dim=1).to(i32), f["done"].view(N),
            f["died"].view(N), f["paused"].view(N),
            f["d_lane"].view(N).to(i32))


def _check(P, row, h, hsize, mm, valid, d_lane, done, died, best, urem,
           vrem, kbase, rowbase, W, D, GENS, cut_depth):
    if W % 32 or W <= 0 or not 1 <= D <= 143 or GENS < 0:
        raise ValueError(f"unsupported shape W={W} D={D} GENS={GENS}")
    if cut_depth != 15:
        raise NotImplementedError("cut_depth 15 only (history >= 30)")
    N = P.shape[0]
    K = 2 * D + 1
    want = {"P": (P, (N, 6 * (W // 32)), torch.int32),
            "row": (row, (N, K), torch.int32),
            "h": (h, (N, K), torch.int64),
            "hsize": (hsize, (N, K), torch.int32),
            "mm": (mm, (N, K), torch.int32),
            "valid": (valid, (N, K), torch.bool),
            "d_lane": (d_lane, (N,), torch.int32),
            "done": (done, (N,), torch.bool),
            "died": (died, (N,), torch.bool),
            "best": (best, (N, 4), torch.int32),
            "urem": (urem, (N,), torch.int32),
            "vrem": (vrem, (N,), torch.int32),
            "kbase": (kbase, (N,), torch.int32),
            "rowbase": (rowbase, (N,), torch.int32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != P.device:
            raise ValueError(f"{name} is on {t.device}, P on {P.device}")


def greedy_chunk(P, row, h, hsize, mm, valid, d_lane, done, died, best,
                 urem, vrem, kbase, rowbase, mmp128: int, mad: int,
                 match_score: int, difference_score: int, hist_cap: int,
                 W: int, D: int, GENS: int, cut_depth: int = 15):
    """K2 on P's device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. The inputs are not modified; returns the
    new state (see the module docstring) on that device."""
    check_history(hist_cap)
    args = (P, row, h, hsize, mm, valid, d_lane, done, died, best, urem,
            vrem, kbase, rowbase)
    _check(*args, W, D, GENS, cut_depth)
    sc = (int(mmp128), int(mad), int(match_score), int(difference_score),
          int(hist_cap))
    if P.device.type == "cpu":
        return greedy_chunk_plain(*args, *sc, W, D, GENS, cut_depth)
    if P.device.type != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    # the kernel updates the state in place: it works on copies
    P = P.contiguous()
    row, h, hsize, mm, valid, d_lane, done, died, best = (
        t.clone(memory_format=torch.contiguous_format) for t in
        (row, h, hsize, mm, valid, d_lane, done, died, best))
    urem, vrem, kbase, rowbase = (t.contiguous() for t in
                                  (urem, vrem, kbase, rowbase))
    N = P.shape[0]
    paused = torch.zeros(N, dtype=torch.bool, device=P.device)
    if N:
        _kernels.call(
            "gt_greedy_chunk", P.device, P.data_ptr(), row.data_ptr(), h.data_ptr(), hsize.data_ptr(),
            mm.data_ptr(), valid.data_ptr(), d_lane.data_ptr(),
            done.data_ptr(), died.data_ptr(), paused.data_ptr(),
            best.data_ptr(), urem.data_ptr(), vrem.data_ptr(),
            kbase.data_ptr(), rowbase.data_ptr(), N, W, D, gens_cap(GENS),
            cut_depth, *sc)
        _kernels.record_launch(globals())
    return row, h, hsize, mm, valid, best, done, died, paused, d_lane
