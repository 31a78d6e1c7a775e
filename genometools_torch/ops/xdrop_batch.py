"""Batched exact xdrop extension through K3.

Counterpart of ``genometools_tpu/ops/xdrop_batch.py``'s device paths
(``_pallas_tiered``, ``xdrop_extend_batch_exact``,
``_xdrop_pk_from_pool``, ``xdrop_extend_batch_pool``): every lane runs in
one launch of K3 (``ops/xdrop_full.py``), which reads its flanks from
the uploaded pool clipped at a window tier and moves a lane to the next
tier when its front reaches the clip or the generation cap. The lanes
still unsafe at the last of TIERS run again in a second launch at
WIDE_TIERS; the lanes K3 reports unsafe there re-run on the exact host
engine (``_host_exact``), so the merged result is bit-equal to the
scalar engine ``ops/xdrop.py::xdrop_extend`` on every lane.

K3 takes any scores whose unit distances are (1, 1, 1), with their
quantum and half (seed_extend's (2, -1, -2, -2): quantum 3;
ltrharvest's and tirvish's (2, -2, -3, -3): quantum 4), at a
belowscore within the ring of that quantum
(``xdrop_full.max_belowscore``; beyond it K3 raises). Every lane of
other scores runs on the scalar engine, as in the reference; so do the
host lanes of non-default unit scores, which the native batch engine
does not know.

The reference sends lanes longer than 512 and lanes whose end diagonal
lies outside its D = 32 band to the host before its kernel runs,
because its windows had to fit TPU VMEM (its xdrop_batch.py:293-309).
Neither filter is needed for exactness here (ops/xdrop_full.py), so K3
takes those lanes too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.native import xdrop_batch_native
from ..device import resolve_device
from .pool import pool_flanks, upload_pool
from .xdrop import XdropScores, xdrop_extend
from .xdrop_full import max_belowscore, xdrop_full

# K = 129 slots: on at1MB's workload D = 32 leaves a tenth of the lanes
# at the slot edge, D = 64 under 1 % (PERF.md); the kernel computes only
# the slot groups the live window holds, so a narrow front costs the same
D_BAND = 64
# (W, GENS) window tiers, from at1MB's flank lengths (PERF.md): flanks are
# clipped at W; the first holds 98 % of them, the second every one
TIERS = ((512, 512), (2048, 2048))
# the tiers of the second launch, for the lanes still unsafe at 2,048:
# repeats of up to 20 kbp (g4m's, repfind's maximal pairs in them) extend
# that far. A launch reserves its widest window's shared memory for every
# warp, so these stay out of the first launch, whose occupancy they would
# cut from 24 warps an SM to 8. A lane still unsafe at the last goes to
# the host engine
WIDE_TIERS = ((8192, 8192), (32768, 32768))
# the reference's routing filters (its xdrop_batch.py:309), counted in
# stats: lanes longer than its widest window, or with |ulen - vlen|
# beyond its band
REF_MAXLEN, REF_BAND = 512, 32

# lanes finished by K3 (kernel or plain version), by the tier they
# finished at (TIERS, then WIDE_TIERS), among them those the reference's filters route to the host
# (longer than REF_MAXLEN, |ulen - vlen| > REF_BAND); lanes routed to the host
# engine and the flank symbols copied for them; lanes run again at
# WIDE_TIERS; all lanes those filters route to the host; lanes of
# non-unit scores, all on the scalar engine. Summed over calls; reset
# with reset_stats()
stats: dict = {}


def reset_stats() -> None:
    stats.update(kernel_lanes=0,
                 tier_lanes=[0] * (len(TIERS) + len(WIDE_TIERS)),
                 long_lanes=0, offband_lanes=0, host_lanes=0, host_symbols=0,
                 wide_lanes=0, filtered_lanes=0, scalar_lanes=0)


reset_stats()


def _host_exact(us, vs, belowscore, scores: XdropScores = XdropScores()):
    """Exact host engine: the C++ batch for the default scores, the
    scalar engine for any other."""
    if scores != XdropScores():
        best = [xdrop_extend(u, v, belowscore, scores) for u, v in zip(us, vs)]
        return tuple(np.asarray([getattr(b, f) for b in best], np.int64)
                     for f in ("ivalue", "jvalue", "score"))
    res = xdrop_batch_native(us, vs, belowscore)
    if res is None:
        raise RuntimeError("the native host engine is unavailable")
    return (res[:, 0].astype(np.int64), res[:, 1].astype(np.int64),
            res[:, 2].astype(np.int64))


def check_belowscore(belowscore: int, scores: XdropScores) -> None:
    """Raise ValueError where K3 would take the lanes (unit distances)
    and belowscore lies beyond its ring at the scores' quantum."""
    sub, ins, dele, quantum, mat2 = scores.distances()
    top = max_belowscore(quantum, mat2 // 2)
    if (sub, ins, dele) == (1, 1, 1) and not 0 <= belowscore <= top:
        raise ValueError(f"xdrop belowscore {belowscore} out of range "
                         f"[0, {top}] at quantum {quantum}")


def xdrop_extend_batch_pool(pool: np.ndarray, u_off, u_len, v_off, v_len,
                            rev, belowscore: int,
                            scores: XdropScores = XdropScores(),
                            device="cuda", gp: torch.Tensor | None = None):
    """Exact xdrop of u = pool[u_off:+u_len] against v = pool[v_off:+v_len]
    (both reversed when rev[i]) under `scores`. Returns int64 (ivalue,
    jvalue, score)."""
    dev = resolve_device(device)
    check_belowscore(belowscore, scores)
    N = int(np.asarray(u_off).size)
    if N == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy()
    u_off = np.asarray(u_off, np.int64)
    u_len = np.asarray(u_len, np.int64)
    v_off = np.asarray(v_off, np.int64)
    v_len = np.asarray(v_len, np.int64)
    rev = np.asarray(rev, bool)
    sub, ins, dele, quantum, mat2 = scores.distances()
    if (sub, ins, dele) != (1, 1, 1):
        stats["scalar_lanes"] += N
        return _host_exact(*pool_flanks(pool, u_off, u_len, v_off, v_len,
                                        rev, range(N)), belowscore, scores)
    T = pool.size
    if gp is None:
        gp = upload_pool(pool, dev)
    desc = [torch.from_numpy(a).to(dev) for a in (
        np.where(rev, T - u_off - u_len, u_off), u_len,
        np.where(rev, T - v_off - v_len, v_off), v_len, rev)]
    kq = dict(quantum=quantum, half=mat2 // 2)
    out, _ = xdrop_full(gp, *desc, belowscore, TIERS, D_BAND, **kq)
    out = out.cpu().numpy().astype(np.int64)
    # unsafe at the last tier: clipped or capped there, or at the slot
    # edge (the result does not tell; a wider window leaves an edge lane
    # unsafe at the same generation)
    wide = np.flatnonzero((out[3] != 0) & (out[4] == len(TIERS) - 1))
    if wide.size:
        stats["wide_lanes"] += int(wide.size)
        sel = torch.from_numpy(wide).to(dev)
        out2, _ = xdrop_full(gp, *(a[sel] for a in desc), belowscore,
                             WIDE_TIERS, D_BAND, **kq)
        out[:, wide] = out2.cpu().numpy()
        out[4, wide] += len(TIERS)
    iv, jv, sv = out[0], out[1], out[2]
    ok = out[3] == 0
    stats["kernel_lanes"] += int(ok.sum())
    stats["tier_lanes"] = [a + int(b) for a, b in zip(
        stats["tier_lanes"], np.bincount(out[4][ok],
                                         minlength=len(stats["tier_lanes"])))]
    long = np.maximum(u_len, v_len) > REF_MAXLEN
    offband = np.abs(u_len - v_len) > REF_BAND
    stats["long_lanes"] += int((ok & long).sum())
    stats["offband_lanes"] += int((ok & offband).sum())
    stats["filtered_lanes"] += int((long | offband).sum())
    redo = np.flatnonzero(~ok)
    if redo.size:
        stats["host_lanes"] += int(redo.size)
        stats["host_symbols"] += int((u_len[redo] + v_len[redo]).sum())
        us, vs = pool_flanks(pool, u_off, u_len, v_off, v_len, rev, redo)
        iv[redo], jv[redo], sv[redo] = _host_exact(us, vs, belowscore,
                                                   scores)
    return iv, jv, sv


def xdrop_extend_batch_exact(us, vs, belowscore: int,
                             scores: XdropScores = XdropScores(),
                             device="cuda"):
    """Array form: exact xdrop of us[i] against vs[i] (both forward)."""
    lens_u = np.asarray([len(u) for u in us], np.int64)
    lens_v = np.asarray([len(v) for v in vs], np.int64)
    parts = [np.asarray(x, np.uint8) for x in list(us) + list(vs)]
    pool = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    if pool.size == 0:
        pool = np.zeros(1, np.uint8)
    u_off = np.cumsum(lens_u) - lens_u
    v_off = int(lens_u.sum()) + np.cumsum(lens_v) - lens_v
    return xdrop_extend_batch_pool(pool, u_off, lens_u, v_off, lens_v,
                                   np.zeros(len(us), bool), belowscore,
                                   scores, device=device)
