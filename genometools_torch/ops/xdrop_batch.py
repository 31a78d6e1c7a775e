"""Batched exact xdrop extension through K3.

Counterpart of ``genometools_tpu/ops/xdrop_batch.py``'s device paths
(``_pallas_tiered``, ``xdrop_extend_batch_exact``,
``_xdrop_pk_from_pool``, ``xdrop_extend_batch_pool``): lanes run in K3
(``ops/xdrop_full.py``) at the first window tier (256, 512) that holds
them; lanes longer than 512, lanes whose end diagonal lies outside the
D=32 band, and lanes K3 reports unsafe re-run on the exact host engine
(``_host_exact``), so the merged result is bit-equal to the scalar
engine ``ops/xdrop.py::xdrop_extend`` on every lane.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.native import xdrop_batch_native
from ..device import resolve_device
from .pool import pk_from_pool, pool_flanks, upload_pool
from .xdrop_full import xdrop_full

D_BAND = 32          # K = 65 slots; lanes leaving the band re-run exactly
TIERS = (256, 512)
GENS = 512

# lanes finished by K3 (kernel or plain version) and lanes routed to the
# host engine, summed over calls; reset with reset_stats()
stats = {"kernel_lanes": 0, "host_lanes": 0}


def reset_stats() -> None:
    stats["kernel_lanes"] = 0
    stats["host_lanes"] = 0


def _host_exact(us, vs, belowscore):
    """Exact host engine: the C++ batch."""
    res = xdrop_batch_native(us, vs, belowscore)
    if res is None:
        raise RuntimeError("the native host engine is unavailable")
    return (res[:, 0].astype(np.int64), res[:, 1].astype(np.int64),
            res[:, 2].astype(np.int64))


def xdrop_extend_batch_pool(pool: np.ndarray, u_off, u_len, v_off, v_len,
                            rev, belowscore: int, device="cuda",
                            gp: torch.Tensor | None = None):
    """Exact xdrop of u = pool[u_off:+u_len] against v = pool[v_off:+v_len]
    (both reversed when rev[i]). Returns int64 (ivalue, jvalue, score)."""
    dev = resolve_device(device)
    N = int(np.asarray(u_off).size)
    z = np.zeros(N, np.int64)
    iv, jv, sv = z.copy(), z.copy(), z.copy()
    if N == 0:
        return iv, jv, sv
    u_off = np.asarray(u_off, np.int64)
    u_len = np.asarray(u_len, np.int64)
    v_off = np.asarray(v_off, np.int64)
    v_len = np.asarray(v_len, np.int64)
    rev = np.asarray(rev, bool)
    lens = np.maximum(u_len, v_len)
    dif = np.abs(u_len - v_len)
    host_mask = (lens > TIERS[-1]) | (dif > D_BAND)
    redo = [np.flatnonzero(host_mask)]
    T = pool.size
    if gp is None:
        gp = upload_pool(pool, dev)
    desc = [torch.from_numpy(a).to(dev) for a in (
        np.where(rev, T - u_off - u_len, u_off), u_len,
        np.where(rev, T - v_off - v_len, v_off), v_len, rev)]
    pending = []
    for W in TIERS:
        tier = np.flatnonzero(~host_mask & (lens <= W))
        host_mask[tier] = True
        if tier.size == 0:
            continue
        tier = tier[np.argsort(lens[tier], kind="stable")]
        idx = torch.from_numpy(tier).to(dev)
        pk = pk_from_pool(gp, *(a[idx] for a in desc), None, W)
        pending.append((tier, xdrop_full(pk, belowscore, W, D_BAND, GENS)))
    for tier, out in pending:
        out = out.cpu().numpy()
        iv[tier] = out[0]
        jv[tier] = out[1]
        sv[tier] = out[2]
        bad = out[3] != 0
        redo.append(tier[bad])
        stats["kernel_lanes"] += int((~bad).sum())
    redo = np.concatenate(redo)
    if redo.size:
        stats["host_lanes"] += int(redo.size)
        us, vs = pool_flanks(pool, u_off, u_len, v_off, v_len, rev, redo)
        iv[redo], jv[redo], sv[redo] = _host_exact(us, vs, belowscore)
    return iv, jv, sv


def xdrop_extend_batch_exact(us, vs, belowscore: int, device="cuda"):
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
                                   device=device)
