"""The resident K2 (genometools_torch/ops/greedy_resident.py) against the
scalar engine, the reference's chunk loop and the host route, its plain
twins of the kernel's pool reader and generation 0 against the chunk
loop's, and the CUDA kernel against its plain version (on a card only).
All comparisons are exact (integers, tolerance 0).

The reference's JAX modules are imported inside the tests, so the CUDA
test also runs where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_greedy_resident.py``.
"""

import numpy as np
import pytest
import torch

from genometools_torch.ops import chunk_loop as tcl
from genometools_torch.ops import greedy_batch as tgb
from genometools_torch.ops import greedy_resident as tgr
from genometools_torch.ops.greedy import PolishingInfo, greedy_extend
from genometools_torch.ops.pool import (chunk_gen0, chunk_windows,
                                        upload_pool)
from genometools_torch.utils.synthetic import mutate
from test_torch_greedy_chunk import (CASES, _check_against_reference,
                                     recorded)  # noqa: F401

torch.set_num_threads(1)

HIST = 64
KW = dict(seedlengths=20, perc_mat_history=55, maxalignedlendifference=30,
          errorpercentage=20, history=HIST)
CFG = tgb.GreedyBatchConfig
WILD = 254


def _sc(kw):
    pol = PolishingInfo.new(float(kw["errorpercentage"]), kw["history"])
    return (tgb._mmp128(kw["perc_mat_history"]),
            kw["maxalignedlendifference"], pol.match_score,
            pol.difference_score, kw["history"])


def _lanes(us, vs, rev=None):
    """Pool and the (ustart, ulen, vstart, vlen, rev) tensors of flank
    pairs; a reversed lane keeps its flanks reversed in the pool."""
    n = len(us)
    rev = np.zeros(n, bool) if rev is None else np.asarray(rev, bool)
    parts = [u[::-1] if r else u for u, r in zip(us, rev)] + \
        [v[::-1] if r else v for v, r in zip(vs, rev)]
    pool = np.concatenate(parts).astype(np.uint8)
    T = pool.size
    lu = np.asarray([len(u) for u in us], np.int64)
    lv = np.asarray([len(v) for v in vs], np.int64)
    uo, vo = np.cumsum(lu) - lu, lu.sum() + np.cumsum(lv) - lv
    su = np.where(rev, T - uo - lu, uo)
    sv = np.where(rev, T - vo - lv, vo)
    t = torch.from_numpy
    return pool, (t(su), t(lu), t(sv), t(lv), t(rev)), (uo, lu, vo, lv, rev)


def _run_plain(us, vs, w_tiers, rev=None, kw=KW):
    """greedy_resident_plain over the pairs with the given window tiers;
    also the (W, D) of every chunk it ran, in order."""
    pool, desc, _ = _lanes(us, vs, rev)
    gp = upload_pool(pool, "cpu")
    seed = torch.full((len(us),), kw["seedlengths"], dtype=torch.int64)
    calls = []
    real = tgr.greedy_chunk_plain

    def rec(*a, **k):
        calls.append((a[-3], a[-2]))
        return real(*a, **k)
    tgr.greedy_chunk_plain = rec
    try:
        out = tgr.greedy_resident(gp, *desc, seed, *_sc(kw),
                                  w_tiers, CFG.D_TIERS, CFG.GENS,
                                  CFG.MAX_CHUNKS)
    finally:
        tgr.greedy_chunk_plain = real
    return out, calls


def _scalar(u, v, kw=KW):
    pol = PolishingInfo.new(float(kw["errorpercentage"]), kw["history"])
    _, b = greedy_extend(u, v, max_history=kw["history"],
                         perc_mat_history=kw["perc_mat_history"],
                         maxalignedlendifference=kw[
                             "maxalignedlendifference"],
                         seedlength=kw["seedlengths"], pol_info=pol)
    return b.alignedlen, b.row, b.distance, b.max_mismatches


def _pair(rng, L, err):
    u = rng.integers(0, 4, L).astype(np.uint8)
    return u, mutate(rng, u, err)


def _case(name):
    """(us, vs, rev, w_tiers, kw) of one named single-behaviour case."""
    rng = np.random.default_rng(17)
    tiers = CFG.W_TIERS
    if name == "reverse":
        us, vs = zip(*(_pair(rng, 3000, e) for e in (0.02, 0.08, 0.12)))
        return list(us), list(vs), [True, False, True], tiers, KW
    if name == "wildcards":
        u, v = _pair(rng, 3000, 0.03)
        u[700:720] = WILD
        v[1500:1503] = WILD
        return [u], [v], None, tiers, KW
    if name == "widen_d":
        u = rng.integers(0, 4, 3000).astype(np.uint8)
        v = np.concatenate([u[:800], rng.integers(0, 4, 40).astype(np.uint8),
                            u[800:]])
        return [u], [mutate(rng, v, 0.02, 0)], None, tiers, KW
    if name in ("top_tier", "relax"):
        # an exact run longer than 384: the window escalates to 1,536,
        # then drops back once the run is crossed; with 384 the widest
        # tier, the lane falls back
        u = rng.integers(0, 4, 4000).astype(np.uint8)
        v = u.copy()
        v[[1500, 2400, 2900, 3300]] = (v[[1500, 2400, 2900, 3300]] + 1) % 4
        return [u], [v], None, tiers[:1] if name == "top_tier" else tiers, KW
    # unrelated flanks under weak trims: the spread outgrows D = 64
    kw = dict(KW, perc_mat_history=30, maxalignedlendifference=100)
    us = [rng.integers(0, 4, 3000).astype(np.uint8) for _ in range(2)]
    vs = [rng.integers(0, 4, 3000).astype(np.uint8) for _ in range(2)]
    return us, vs, None, tiers, kw


@pytest.mark.parametrize("name", ["reverse", "wildcards", "widen_d",
                                  "top_tier", "relax", "fallback"])
def test_plain_matches_scalar_engine(name):
    """Every lane the plain version finishes equals the scalar engine;
    each case shows its behaviour in the chunks it ran and the routes
    (top_tier: a lane that needs a window beyond the widest tier falls
    back)."""
    us, vs, rev, w_tiers, kw = _case(name)
    out, calls = _run_plain(us, vs, w_tiers, rev, kw)
    route = out["route"].numpy()
    for i, (u, v) in enumerate(zip(us, vs)):
        if route[i] == tcl.DONE:
            got = tuple(int(x) for x in out["best"][i].tolist())
            assert got == _scalar(u, v, kw), (name, i)
    ws = [w for w, _ in calls]
    if name in ("fallback", "top_tier"):
        assert (route == tcl.FALLBACK).all()
    else:
        assert (route == tcl.DONE).all()
    if name == "top_tier":
        assert set(ws) == {384}
    if name == "widen_d":
        assert {d for _, d in calls} == {16, 64}
    if name == "relax":
        first = ws.index(1536)
        assert 384 in ws[first:], ws


def _reference_pool(us, vs, kw, rv):
    """The pool form of the pairs with the given lanes reversed (read
    backwards from the pool), and the reference batch's result on it."""
    from genometools_tpu.ops import greedy_batch as rgb
    pool, _, host = _lanes(us, vs, rv)
    cfg = rgb._GreedyBatchConfig()
    cfg.GENS = 48
    return pool, host, rgb.greedy_extend_batch_pool(pool, *host, cfg=cfg,
                                                    **kw)


@pytest.mark.parametrize("form", ["array", "pool"])
@pytest.mark.parametrize("case", list(CASES))
def test_resident_route_matches_reference(recorded, case, form):
    """The batch through the resident kernel's plain version equals the
    reference's chunk loop lane by lane, fallback lanes included, on the
    recorded cases of test_torch_greedy_chunk: as arrays, and in the pool
    form with every other lane reversed."""
    us, vs, kw, ref, _ = recorded[case]

    class Cfg(tgb.GreedyBatchConfig):
        FULL_W = 0
        RESCUE = None
        GENS = 48
    tgb.reset_stats()
    if form == "array":
        got = tgb.greedy_extend_batch(us, vs, cfg=Cfg(), device="cpu", **kw)
    else:
        rv = np.arange(len(us)) % 2 == 1
        pool, host, ref = _reference_pool(us, vs, kw, rv)
        got = tgb.greedy_extend_batch_pool(pool, *host, cfg=Cfg(),
                                           device="cpu", **kw)
    _check_against_reference(ref, got)
    assert tgb.stats["chunk_lanes"] == 0
    assert tgb.stats["resident_lanes"] == int((~ref["fallback"]).sum()) > 0


def _random_lanes(seed, n=64):
    rng = np.random.default_rng(seed)
    us, vs = [], []
    for t in range(n):
        L = int(rng.integers(0, 2600))
        u, v = _pair(rng, max(L, 1), rng.uniform(0, 0.1))
        if t % 5 == 0:
            u[rng.integers(0, u.size, 3)] = WILD
        if t % 7 == 0:
            v = u.copy()
        us.append(u[:L])
        vs.append(v)
    return us, vs, rng.integers(0, 2, n).astype(bool)


def test_pool_window_twin():
    """The kernel's pool reader (funnel shift of word pairs) equals the
    chunk loop's window gather lane by lane, at shifted origins."""
    us, vs, rev = _random_lanes(5)
    pool, desc, _ = _lanes(us, vs, rev)
    gp = upload_pool(pool, "cpu")
    rng = np.random.default_rng(6)
    for W in (384, 1536):
        du = torch.from_numpy(rng.integers(0, 3000, len(us)))
        dv = torch.from_numpy(rng.integers(0, 3000, len(us)))
        assert torch.equal(tgr.pool_windows_plain(gp, *desc, du, dv, W),
                           chunk_windows(gp, *desc, du, dv, W))


def test_gen0_twin():
    """The kernel's generation 0 (the match run 1,024 symbols at a time)
    equals chunk_gen0's lane by lane: run length and centre slot."""
    us, vs, rev = _random_lanes(8)
    u = np.random.default_rng(9).integers(0, 4, 2500).astype(np.uint8)
    us += [u, u, u[:0]]
    vs += [u.copy(), u[:1100], u]         # runs of 2,500, 1,100 and 0
    rev = np.concatenate([rev, [False, True, False]])
    pool, desc, _ = _lanes(us, vs, rev)
    gp = upload_pool(pool, "cpu")
    seed = torch.from_numpy(np.random.default_rng(3).integers(
        1, 90, len(us)))
    c0, h0, hs0 = tgr.resident_gen0_plain(gp, *desc, seed, HIST)
    c0_ref, (row, h, hs, mm, valid) = chunk_gen0(gp, *desc, seed, HIST, 64)
    assert np.array_equal(c0.numpy(), c0_ref)
    assert c0_ref[-3:].tolist() == [2500, 1100, 0]
    assert torch.equal(h0, h[:, 64]) and torch.equal(hs0, hs[:, 64])
    assert bool(valid[:, 64].all()) and int(valid.sum()) == len(us)


def test_batch_resident_route_matches_host():
    """greedy_extend_batch_pool on a pool of long planted repeats
    (homologous flanks of 2,000-5,000, both directions): the resident
    route equals the host route (skip_chunked=True) on every lane."""
    rng = np.random.default_rng(21)
    us, vs = zip(*(_pair(rng, int(rng.integers(2000, 5000)),
                         rng.uniform(0.01, 0.1)) for _ in range(10)))
    rev = rng.integers(0, 2, len(us)).astype(bool)
    pool, _, (uo, lu, vo, lv, rv) = _lanes(list(us), list(vs), rev)
    tgb.reset_stats()
    a = tgb.greedy_extend_batch_pool(pool, uo, lu, vo, lv, rv, device="cpu",
                                     **KW)
    assert tgb.stats["resident_lanes"] > 0
    assert tgb.stats["resident_lanes"] + tgb.stats["kernel_lanes"] + \
        tgb.stats["chunk_lanes"] + tgb.stats["host_lanes"] == len(us)
    b = tgb.greedy_extend_batch_pool(pool, uo, lu, vo, lv, rv, device="cpu",
                                     skip_chunked=True, **KW)
    for k in ("alignedlen", "row", "distance", "mismatches", "died"):
        assert np.array_equal(a[k], b[k]), k


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wmax", list(CFG.W_TIERS))
def test_cuda_kernel_matches_plain(cuda_device, wmax):
    """The kernel equals the plain version on every output with window
    tiers up to each tier wmax (the shared memory it holds), with lanes
    in both slot tiers, escalating, relaxing and falling back; the batch
    through it equals the host route."""
    lanes = []
    for name in ("reverse", "wildcards", "widen_d", "relax"):
        us, vs, rev, _, _ = _case(name)
        lanes += list(zip(us, vs, rev if rev is not None else [False] *
                          len(us)))
    r2, s2, v2 = _random_lanes(11)
    lanes += list(zip(r2, s2, v2))
    # an exact run of 9,400 after the seed's first mismatch: the window
    # escalates to 24,576
    u = np.random.default_rng(12).integers(0, 4, 12000).astype(np.uint8)
    v = u.copy()
    v[[100, 9500, 11000]] ^= 1
    lanes.append((u, v, True))
    us, vs, rev = (list(x) for x in zip(*lanes))
    pool, desc, host = _lanes(us, vs, rev)
    gp = upload_pool(pool, "cpu")
    seed = torch.from_numpy(np.random.default_rng(4).integers(
        10, 40, len(us)))
    tiers = tuple(w for w in CFG.W_TIERS if w <= wmax)
    args = (*_sc(KW), tiers, CFG.D_TIERS, CFG.GENS, CFG.MAX_CHUNKS)
    cnt = {}
    plain = tgr.greedy_resident_plain(gp, *desc, seed, *args, counts=cnt)
    kern = tgr.greedy_resident(gp.to(cuda_device),
                               *(t.to(cuda_device) for t in desc),
                               seed.to(cuda_device), *args)
    torch.cuda.synchronize()
    assert {d for _, d in cnt["chunks"]} == set(CFG.D_TIERS)
    assert wmax in {w for w, _ in cnt["chunks"]}
    assert set(plain) == set(kern)
    for k in plain:
        assert torch.equal(plain[k], kern[k].cpu()), k

    class Cfg(tgb.GreedyBatchConfig):
        W_TIERS = tiers
    a = tgb.greedy_extend_batch_pool(pool, *host, cfg=Cfg(),
                                     device=cuda_device, **KW)
    b = tgb.greedy_extend_batch_pool(pool, *host, device=cuda_device,
                                     skip_chunked=True, **KW)
    for k in ("alignedlen", "row", "distance", "mismatches", "died"):
        assert np.array_equal(a[k], b[k]), k
