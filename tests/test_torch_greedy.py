"""K1 (single-shot greedy extension) in genometools_torch against the
reference: the plain PyTorch version, reading its windows from the pool,
against the Pallas kernel in interpret mode and the scalar engine
(lanes that move up a slot tier included), the pool batch against the
reference batch and the scalar engine, and the CUDA kernel against the
plain version (on a card only). All comparisons are exact (integers,
tolerance 0).

The reference's JAX modules are imported inside the tests, so the
CUDA test also runs where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import numpy as np
import pytest
import torch

from genometools_torch.ops import greedy_batch as tgb
from genometools_torch.ops.greedy_full import greedy_full, greedy_full_plain
from genometools_torch.ops.pool import pack_codes, upload_pool

torch.set_num_threads(1)

PMH, MAD, HIST = 55, 30, 60


def _tasks(rng, n, maxlen, err_lo=0.02, err_hi=0.4):
    """Homology-shaped flank pairs: v is u with 2-40 % substitutions,
    occasional indels and wildcards."""
    us, vs = [], []
    for _ in range(n):
        L = int(rng.integers(1, maxlen))
        u = rng.integers(0, 4, L).astype(np.uint8)
        v = u.copy()
        err = rng.uniform(err_lo, err_hi)
        for p in rng.integers(0, L, int(err * L)):
            v[p] = rng.integers(0, 4)
        if rng.random() < 0.3 and v.size > 3:
            v = np.delete(v, rng.integers(0, v.size, 2))
        if rng.random() < 0.3:
            ins = rng.integers(0, 4, 3).astype(np.uint8)
            v = np.insert(v, int(rng.integers(0, v.size + 1)), ins)
        if rng.random() < 0.3:
            u[rng.integers(0, u.size)] = 254
        us.append(u)
        vs.append(v[:maxlen])
    return us, vs


def _pk(us, vs, seedl, W):
    N = len(us)
    U = np.full((N, W), 254, np.uint8)
    V = np.full((N, W), 255, np.uint8)
    for i, (u, v) in enumerate(zip(us, vs)):
        U[i, :len(u)] = u
        V[i, :len(v)] = v
    W32 = W // 32
    PK = np.zeros((N, 6 * W32 + 3), np.uint32)
    for ci, plane in enumerate(pack_codes(U) + pack_codes(V)):
        PK[:, ci * W32:(ci + 1) * W32] = plane
    PK[:, 6 * W32] = seedl
    PK[:, 6 * W32 + 1] = [len(u) for u in us]
    PK[:, 6 * W32 + 2] = [len(v) for v in vs]
    return PK


def _pool(us, vs):
    parts = list(us) + list(vs)
    pool = np.concatenate(parts)
    lu = np.asarray([len(u) for u in us], np.int64)
    lv = np.asarray([len(v) for v in vs], np.int64)
    return pool, np.cumsum(lu) - lu, lu, lu.sum() + np.cumsum(lv) - lv, lv


def _lanes(us, vs, seedl, rev=None, device="cpu"):
    """The uploaded pool and the (ustart, ulen, vstart, vlen, rev,
    seedlen) tensors of flank pairs; a reversed lane keeps its flanks
    reversed in the pool, so the reversed planes read them forward."""
    n = len(us)
    rev = np.zeros(n, bool) if rev is None else np.asarray(rev, bool)
    parts = [u[::-1] if r else u for u, r in zip(us, rev)] + \
        [v[::-1] if r else v for v, r in zip(vs, rev)]
    pool = np.concatenate(parts).astype(np.uint8)
    T = pool.size
    lu = np.asarray([len(u) for u in us], np.int64)
    lv = np.asarray([len(v) for v in vs], np.int64)
    uo, vo = np.cumsum(lu) - lu, lu.sum() + np.cumsum(lv) - lv
    desc = [np.where(rev, T - uo - lu, uo), lu, np.where(rev, T - vo - lv, vo),
            lv, rev, np.zeros(n, np.int64) + np.asarray(seedl, np.int64)]
    return upload_pool(pool, device), tuple(
        torch.from_numpy(a).to(device) for a in desc)


def _pol():
    from genometools_tpu.ops.greedy import PolishingInfo
    return PolishingInfo.new(20.0, HIST)


# (W, D, GENS, history): the second case leaves lanes undone at the slot
# edge, the third at the generation cap
@pytest.mark.parametrize("shape", [(256, 16, 96, 60), (256, 4, 96, 64),
                                   (256, 16, 8, 64)])
def test_plain_matches_pallas_interpret(shape):
    from genometools_tpu.ops.greedy_pallas import greedy_full_pallas
    W, D, GENS, hist = shape
    rng = np.random.default_rng(W + D + GENS)
    us, vs = _tasks(rng, 48, W)
    seedl = rng.integers(10, 70, len(us))
    PK = _pk(us, vs, seedl, W)
    args = (117, 30, 400, 600, hist)
    ref = greedy_full_pallas(PK, *args, W, D, GENS, interpret=True)
    # every other lane read from the reversed planes
    gp, desc = _lanes(us, vs, seedl, np.arange(len(us)) % 2 == 1)
    got, _ = greedy_full(gp, *desc, *args, W, (D,), GENS)
    assert np.array_equal(ref, got.numpy())


def _edge_tasks(rng, n, L, gap):
    """Homologous flanks of up to L symbols, most with an insertion of
    up to `gap` symbols: the live front must widen past the slot edge of
    a narrow tier."""
    us, vs = _tasks(rng, n, L, 0.01, 0.05)
    for i in range(0, n, 3):
        g = rng.integers(0, 4, int(rng.integers(gap // 2, gap))
                         ).astype(np.uint8)
        p = int(rng.integers(0, vs[i].size + 1))
        vs[i] = np.concatenate([vs[i][:p], g, vs[i][p:]])[:L]
    return us, vs


# (W, d_tiers, GENS, reference D): a lane that touches the first tier's
# slot edge goes on at the second and must end as the reference run at
# the second tier's D ends it
@pytest.mark.parametrize("case", [(256, (4, 16), 96, 16),
                                  (256, (2, 8), 48, 8)])
def test_slot_ladder_matches_pallas_interpret(case):
    from genometools_tpu.ops.greedy_pallas import greedy_full_pallas
    W, d_tiers, GENS, D = case
    rng = np.random.default_rng(W + sum(d_tiers))
    us, vs = _edge_tasks(rng, 48, W, 24)
    seedl = rng.integers(10, 70, len(us))
    args = (117, 30, 400, 600, 64)
    ref = greedy_full_pallas(_pk(us, vs, seedl, W), *args, W, D, GENS,
                             interpret=True)
    gp, desc = _lanes(us, vs, seedl)
    got, _ = greedy_full(gp, *desc, *args, W, d_tiers, GENS)
    assert np.array_equal(ref, got.numpy())
    # some lanes touched the first tier's edge and finished above it
    first, _ = greedy_full(gp, *desc, *args, W, d_tiers[:1], GENS)
    assert int(((first[6] == 1) & (got[4] == 1)).sum()) > 0


def test_slot_ladder_matches_scalar():
    """Under weak trims, lanes that touch D = 16's slot edge finish at
    D = 64 (the main path's tiers), each as the scalar engine finishes
    it."""
    from genometools_tpu.ops.greedy import greedy_extend
    rng = np.random.default_rng(29)
    us, vs = _edge_tasks(rng, 36, 300, 40)
    pol = _pol()
    gp, desc = _lanes(us, vs, 14, rng.integers(0, 2, len(us)))
    sc = (tgb._mmp128(PMH), MAD, pol.match_score, pol.difference_score, HIST)
    cnt = {}
    got = greedy_full_plain(gp, *desc, *sc, 320, (16, 64), 1536,
                            counts=cnt)
    lo, _ = greedy_full(gp, *desc, *sc, 320, (16,), 1536)
    assert int(((lo[6] == 1) & (got[4] == 1)).sum()) > 0
    assert cnt["slot_gens"] > 0
    for i in np.flatnonzero(got[4].numpy()):
        _, best = greedy_extend(
            us[i], vs[i], max_history=HIST, perc_mat_history=PMH,
            maxalignedlendifference=MAD, seedlength=14, pol_info=pol)
        assert tuple(int(x) for x in got[:4, i]) == (
            best.alignedlen, best.row, best.distance,
            best.max_mismatches), i


def test_pool_batch_matches_reference(monkeypatch):
    """Same pool, same flags: the port's batch equals the reference
    batch driven by its interpret-mode kernel, lane for lane."""
    from genometools_tpu.ops import greedy_batch as gb
    from genometools_tpu.ops.greedy_pallas import greedy_full_pallas

    def full_shim(*a, **kw):
        return greedy_full_pallas(*a, **kw, interpret=True)
    monkeypatch.setattr(gb, "greedy_full_impl", full_shim)
    rng = np.random.default_rng(3)
    us, vs = _tasks(rng, 24, 200, 0.02, 0.12)
    pool, uo, ul, vo, vl = _pool(us, vs)
    rv = rng.integers(0, 2, len(us)).astype(bool)
    kw = dict(seedlengths=14, perc_mat_history=PMH,
              maxalignedlendifference=MAD, pol_info=_pol(), history=HIST)
    ref = gb.greedy_extend_batch_pool(pool, uo, ul, vo, vl, rv, **kw)
    got = tgb.greedy_extend_batch_pool(pool, uo, ul, vo, vl, rv,
                                       device="cpu", **kw)
    for key in ("alignedlen", "row", "distance", "mismatches", "died"):
        assert np.array_equal(ref[key], got[key]), key


def test_batch_matches_scalar_with_host_routing():
    """Tiny passes force undone lanes onto the C++ host route (the chunk
    chunk loop skipped); every lane must still equal the scalar engine, and
    the lane counts must add up."""
    from genometools_tpu.ops.greedy import greedy_extend

    class Tiny(tgb.GreedyBatchConfig):
        FULL_W = 256
        FULL_D = (8,)
        FULL_GENS = 64
        RESCUE = (16, 64)

    rng = np.random.default_rng(11)
    us, vs = _tasks(rng, 40, 300)
    pol = _pol()
    tgb.reset_stats()
    res = tgb.greedy_extend_batch(
        us, vs, seedlengths=14, perc_mat_history=PMH,
        maxalignedlendifference=MAD, pol_info=pol, history=HIST,
        cfg=Tiny(), device="cpu", skip_chunked=True)
    assert tgb.stats["kernel_lanes"] + tgb.stats["host_lanes"] == len(us)
    assert tgb.stats["chunk_lanes"] == 0
    assert tgb.stats["kernel_lanes"] > 0 and tgb.stats["host_lanes"] > 0
    for i in range(len(us)):
        _, best = greedy_extend(
            us[i], vs[i], max_history=HIST, perc_mat_history=PMH,
            maxalignedlendifference=MAD, seedlength=14, pol_info=pol)
        assert (res["alignedlen"][i], res["row"][i], res["distance"][i],
                res["mismatches"][i]) == (best.alignedlen, best.row,
                                          best.distance,
                                          best.max_mismatches), i


def test_history_bounds_raise():
    with pytest.raises(NotImplementedError):
        tgb.greedy_extend_batch([np.zeros(3, np.uint8)],
                                [np.zeros(3, np.uint8)], seedlengths=4,
                                perc_mat_history=PMH,
                                maxalignedlendifference=MAD, history=20,
                                device="cpu")


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# (W, d_tiers, GENS, lanes): the main path's launch (the ladder 16 -> 64)
# and its rescue, single D = 64 tiers at two window widths, then shapes
# that leave lanes undone at the slot edge and at the generation cap, so
# the kernel's pause paths are compared too; the first case holds some
# 12 times the card's resident warps, so every persistent warp takes
# several lanes from the queue
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1536, (16, 64), 1536, 20000),
                                   (1536, (128,), 6144, 600),
                                   (256, (64,), 1536, 300),
                                   (1536, (64,), 1536, 300),
                                   (256, (4,), 96, 300),
                                   (256, (16,), 8, 300)])
def test_cuda_kernel_matches_plain(cuda_device, shape):
    W, d_tiers, GENS, n = shape
    rng = np.random.default_rng(W + sum(d_tiers))
    us, vs = _edge_tasks(rng, n, W, 40)
    gp, desc = _lanes(us, vs, rng.integers(10, 70, n),
                      rng.integers(0, 2, n), device=cuda_device)
    args = (117, 30, 400, 600, 64)
    cnt = {}
    plain = greedy_full_plain(gp, *desc, *args, W, d_tiers, GENS,
                              counts=cnt)
    kern, slot_gens = greedy_full(gp, *desc, *args, W, d_tiers, GENS)
    torch.cuda.synchronize()
    assert torch.equal(plain, kern)
    assert int(slot_gens) == cnt["slot_gens"]
    if d_tiers[-1] < 64:
        assert int(plain[6].sum()) > 0
