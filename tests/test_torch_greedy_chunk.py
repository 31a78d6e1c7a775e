"""K2 (the resumable greedy chunk) and the windowed chunk loop in
genometools_torch against the reference: the plain PyTorch version
against the reference's XLA twin call by call and against the Pallas
kernel in interpret mode, the port's chunk loop against the reference's
lane by lane (same GENS), the whole batch against the scalar engine,
and the CUDA kernel against the plain version (on a card only). All
comparisons are exact (integers, tolerance 0).

The reference's JAX modules are imported inside the tests, so the
CUDA test also runs where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_greedy_chunk.py``.
"""

import numpy as np
import pytest
import torch

from genometools_torch.ops import greedy_batch as tgb
from genometools_torch.ops import greedy_chunk as tgc
from genometools_torch.ops.pool import pack_codes

torch.set_num_threads(1)

GENS = 48            # the reference's GENS for its XLA twin
HIST = 64


def _mutate(rng, u, err, indel=0.005):
    """u with `err` substitutions and `indel` indels of 1-3 symbols."""
    v = u.copy()
    n = int(err * len(u))
    pos = rng.integers(0, len(u), n)
    v[pos] = (v[pos] + rng.integers(1, 4, n)) % 4
    out, i = [], 0
    for p in sorted(rng.integers(0, len(v), int(indel * len(v)))):
        out.append(v[i:p])
        i = p
        if rng.random() < 0.5:
            out.append(rng.integers(0, 4, rng.integers(1, 4)).astype(np.uint8))
        else:
            i += int(rng.integers(1, 4))
    out.append(v[i:])
    return np.concatenate(out).astype(np.uint8)


def _long_pairs(seed):
    """Flank pairs of 2,000-6,000 symbols with 1-15 % errors, indels and
    wildcards, plus an exact run longer than 384 (window-tier
    escalation), a 40-symbol insertion (slot-tier escalation) and an
    unrelated pair."""
    rng = np.random.default_rng(seed)
    us, vs = [], []
    for t in range(8):
        L = int(rng.integers(2000, 6000))
        u = rng.integers(0, 4, L).astype(np.uint8)
        v = _mutate(rng, u, rng.uniform(0.01, 0.15))
        if t % 3 == 0:
            u[rng.integers(0, L, 5)] = 254
        us.append(u)
        vs.append(v)
    u = rng.integers(0, 4, 3000).astype(np.uint8)
    v = u.copy()
    v[[1500, 2400]] = (v[[1500, 2400]] + 1) % 4
    us.append(u)
    vs.append(v)
    u = rng.integers(0, 4, 3000).astype(np.uint8)
    v = np.concatenate([u[:800], rng.integers(0, 4, 40).astype(np.uint8),
                        u[800:]])
    us.append(u)
    vs.append(_mutate(rng, v, 0.02))
    us.append(rng.integers(0, 4, 2500).astype(np.uint8))
    vs.append(rng.integers(0, 4, 2500).astype(np.uint8))
    return us, vs


def _spread_pairs(seed):
    """Unrelated pairs under weak trims (percmathistory 30,
    maxalignedlendifference 100): the live front spreads beyond D=64
    and the chunk loop gives up on the lane (fallback)."""
    rng = np.random.default_rng(seed)
    us = [rng.integers(0, 4, 3000).astype(np.uint8) for _ in range(3)]
    vs = [rng.integers(0, 4, 3000).astype(np.uint8) for _ in range(3)]
    u = rng.integers(0, 4, 2500).astype(np.uint8)
    us.append(u)
    vs.append(_mutate(rng, u, 0.05))
    return us, vs


CASES = {
    "mixed": (_long_pairs, 3, dict(seedlengths=20, perc_mat_history=55,
                                   maxalignedlendifference=30,
                                   errorpercentage=20, history=HIST)),
    "fallback": (_spread_pairs, 5, dict(seedlengths=20, perc_mat_history=30,
                                        maxalignedlendifference=100,
                                        errorpercentage=20, history=HIST)),
}


class _NoK1(tgb.GreedyBatchConfig):
    """Every lane through the host-driven chunk loop and K2, as the
    reference batch runs on the CPU (its single-shot path needs the
    Pallas kernel)."""
    FULL_W = 0
    RESCUE = None
    GENS = GENS
    RESIDENT = False


@pytest.fixture(scope="module")
def recorded():
    """Per case: the pairs, the reference batch's result and every call
    its chunk loop made to the XLA chunk twin (inputs and outputs)."""
    from genometools_tpu.ops import greedy_batch as rgb
    real_impl = rgb.greedy_chunk_impl
    out = {}
    try:
        for name, (make, seed, kw) in CASES.items():
            calls = []

            def rec(*a):
                res = rgb.greedy_chunk_xla(*a)
                calls.append((a, res))
                return res
            rgb.greedy_chunk_impl = rec
            us, vs = make(seed)
            cfg = rgb._GreedyBatchConfig()
            cfg.GENS = GENS
            ref = rgb.greedy_extend_batch(us, vs, cfg=cfg,
                                          _single_shot=False, **kw)
            out[name] = (us, vs, kw, ref, calls)
    finally:
        rgb.greedy_chunk_impl = real_impl
    return out


def _port_args(a):
    """The port's K2 arguments from a recorded greedy_chunk_xla call:
    U/V code windows become the six bit-planes, hlo/hhi one int64."""
    U, V = np.asarray(a[0]), np.asarray(a[1])
    planes = np.concatenate(list(pack_codes(U)) + list(pack_codes(V)),
                            axis=1).view(np.int32)
    h = (np.asarray(a[3]).astype(np.uint64)
         | (np.asarray(a[4]).astype(np.uint64) << np.uint64(32)))

    def t(x):
        return torch.from_numpy(np.array(x))
    return (t(planes), t(a[2]), t(h.view(np.int64)), *map(t, a[5:16]),
            *(int(x) for x in a[16:21]), *a[21:24])


def _as_reference(out):
    """The port's K2 result in the reference's 11-part layout."""
    g = [x.numpy() for x in out]
    h = g[1].view(np.uint64)
    return [g[0], (h & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (h >> np.uint64(32)).astype(np.uint32), *g[2:]]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_xla_call_by_call(recorded, case):
    *_, calls = recorded[case]
    shapes = {(a[21], a[22]) for a, _ in calls}
    assert len(calls) > 1
    if case == "mixed":     # both window tiers and both slot tiers ran
        assert {w for w, _ in shapes} >= {384, 1536}
        assert {d for _, d in shapes} == {16, 64}
    for a, ref in calls:
        got = _as_reference(tgc.greedy_chunk(*_port_args(a)))
        for i, (g, r) in enumerate(zip(got, ref)):
            assert np.array_equal(g, np.asarray(r)), (a[21], a[22], i)


def test_plain_matches_pallas_interpret():
    """Three lanes of 2,000 (the reference's own long-extension case,
    tests/test_greedy_pallas.py): its first two chunk calls through the
    interpret-mode Pallas kernel and the plain version."""
    from genometools_tpu.ops import greedy_batch as rgb
    from genometools_tpu.ops.greedy import PolishingInfo
    from genometools_tpu.ops.greedy_pallas import greedy_chunk_pallas
    rng = np.random.default_rng(7)
    u = rng.integers(0, 4, 2000).astype(np.uint8)
    v = u.copy()
    for p in rng.integers(0, 2000, 60):
        v[p] = rng.integers(0, 4)
    calls = []

    def rec(*a):
        res = rgb.greedy_chunk_xla(*a)
        calls.append(a)
        return res
    real_impl = rgb.greedy_chunk_impl
    rgb.greedy_chunk_impl = rec
    try:
        rgb.greedy_extend_batch(
            [u] * 3, [v] * 3, seedlengths=14, perc_mat_history=55,
            maxalignedlendifference=30,
            pol_info=PolishingInfo.new(20.0, 60), history=60)
    finally:
        rgb.greedy_chunk_impl = real_impl
    assert calls
    for a in calls[:2]:
        ref = greedy_chunk_pallas(*a, interpret=True)
        got = _as_reference(tgc.greedy_chunk(*_port_args(a)))
        for i, (g, r) in enumerate(zip(got, ref)):
            assert np.array_equal(g, np.asarray(r)), i


def _check_against_reference(ref, got):
    keep = ~ref["fallback"]
    assert np.array_equal(ref["fallback"], got["fallback"])
    for k in ("alignedlen", "row", "distance", "mismatches"):
        assert np.array_equal(ref[k][keep], got[k][keep]), k
    assert np.array_equal(ref["died"], got["died"] & ~got["fallback"])


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_loop_matches_reference(recorded, case):
    """The port's windowed chunk loop (K2's plain version on the CPU) equals
    the reference's lane by lane, fallback lanes included."""
    us, vs, kw, ref, _ = recorded[case]
    tgb.reset_stats()
    got = tgb.greedy_extend_batch(us, vs, cfg=_NoK1(), device="cpu", **kw)
    _check_against_reference(ref, got)
    assert tgb.stats["chunk_lanes"] == int((~ref["fallback"]).sum()) > 0
    if case == "fallback":
        assert ref["fallback"].any()


def test_pool_chunk_loop_matches_reference(recorded):
    """The pool form with reversed (left-flank) lanes: windows gathered
    on the device at the rebased origins of reversed flanks."""
    from genometools_tpu.ops import greedy_batch as rgb
    us, vs, kw, _, _ = recorded["mixed"]
    rng = np.random.default_rng(9)
    rv = rng.integers(0, 2, len(us)).astype(bool)
    # a reversed lane reads its flanks backwards from the pool
    parts = [u[::-1] if r else u for u, r in zip(us, rv)] + \
        [v[::-1] if r else v for v, r in zip(vs, rv)]
    pool = np.concatenate(parts)
    lu = np.asarray([len(u) for u in us], np.int64)
    lv = np.asarray([len(v) for v in vs], np.int64)
    uo, vo = np.cumsum(lu) - lu, lu.sum() + np.cumsum(lv) - lv
    cfg = rgb._GreedyBatchConfig()
    cfg.GENS = GENS
    ref = rgb.greedy_extend_batch_pool(pool, uo, lu, vo, lv, rv, cfg=cfg,
                                       **kw)
    got = tgb.greedy_extend_batch_pool(pool, uo, lu, vo, lv, rv,
                                       cfg=_NoK1(), device="cpu", **kw)
    _check_against_reference(ref, got)


@pytest.mark.parametrize("case", list(CASES))
def test_batch_matches_scalar_engine(recorded, case):
    """The default batch (K1 passes, the chunk loop in the resident
    kernel's plain version, the host engine for fallback lanes) equals
    the scalar engine on every lane."""
    from genometools_tpu.ops.greedy import PolishingInfo, greedy_extend
    us, vs, kw, ref, _ = recorded[case]
    tgb.reset_stats()
    got = tgb.greedy_extend_batch(us, vs, device="cpu", **kw)
    assert tgb.stats["resident_lanes"] > 0
    assert tgb.stats["host_lanes"] == int(got["fallback"].sum())
    pol = PolishingInfo.new(float(kw["errorpercentage"]), HIST)
    for i, (u, v) in enumerate(zip(us, vs)):
        _, b = greedy_extend(u, v, max_history=HIST,
                             perc_mat_history=kw["perc_mat_history"],
                             maxalignedlendifference=kw[
                                 "maxalignedlendifference"],
                             seedlength=kw["seedlengths"], pol_info=pol)
        assert (got["alignedlen"][i], got["row"][i], got["distance"][i],
                got["mismatches"][i]) == (b.alignedlen, b.row, b.distance,
                                          b.max_mismatches), i
    keep = ~ref["fallback"]
    assert np.array_equal(got["died"][keep], ref["died"][keep])


def test_skip_chunked_routes_to_host():
    """skip_chunked=True leaves every lane K1 does not finish to the host
    engine: no K2 lane, the same results."""
    us, vs = _long_pairs(4)
    kw = CASES["mixed"][2]
    a = tgb.greedy_extend_batch(us[:4], vs[:4], device="cpu", **kw)
    tgb.reset_stats()
    b = tgb.greedy_extend_batch(us[:4], vs[:4], device="cpu",
                                skip_chunked=True, **kw)
    assert tgb.stats["chunk_lanes"] == tgb.stats["resident_lanes"] == 0
    assert b["fallback"].all()
    for k in ("alignedlen", "row", "distance", "mismatches", "died"):
        assert np.array_equal(a[k], b[k]), k


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("gens", [GENS, 4])
def test_cuda_kernel_matches_plain(cuda_device, monkeypatch, gens):
    """Every chunk the chunk loop launches on a long-flank batch (the
    generation-0 and the rebased states of both window and slot tiers;
    GENS=4 stops lanes at the generation cap), on the card and in the
    plain version."""
    calls = []
    real = tgb.greedy_chunk

    def rec(*a):
        calls.append(a)
        return real(*a)
    monkeypatch.setattr(tgb, "greedy_chunk", rec)

    class Cfg(_NoK1):
        GENS = gens
    us, vs = _long_pairs(3)
    tgb.greedy_extend_batch(us, vs, cfg=Cfg(), device="cpu",
                            **CASES["mixed"][2])
    assert {a[-3] for a in calls} >= {384, 1536}
    for a in calls:
        plain = tgc.greedy_chunk(*a)
        kern = tgc.greedy_chunk(*(x.to(cuda_device)
                                  if isinstance(x, torch.Tensor) else x
                                  for x in a))
        torch.cuda.synchronize()
        for p, k in zip(plain, kern):
            assert torch.equal(p, k.cpu())
