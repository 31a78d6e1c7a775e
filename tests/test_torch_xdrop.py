"""K3 (single-shot xdrop extension) in genometools_torch against the
reference: the plain PyTorch version, reading its windows from the pool,
against the Pallas kernel in interpret mode, the lax twin and the scalar
engine (lanes the reference's filters sent to the host included: flanks
longer than the window, fronts that reach the clip, |ulen - vlen| beyond
the band, lanes at the slot edge), the pool batch against the reference
batch and the scalar engine, and the CUDA kernel against the plain
version (on a card only). All comparisons are exact (integers,
tolerance 0).

The reference's JAX modules are imported inside the tests, so the
CUDA test also runs where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_*.py``.
"""

import numpy as np
import pytest
import torch

from genometools_torch.ops import xdrop_batch as txb
from genometools_torch.ops import xdrop_full as txf
from genometools_torch.utils.synthetic import mutate
from test_torch_greedy import _lanes

torch.set_num_threads(1)

WILD = 254


def _tasks(rng, n, maxlen, identity=0.85, wildcards=True):
    """v is a mutated copy of u (substitutions, indels), so fronts
    actually extend; every fifth u carries a wildcard."""
    us, vs = [], []
    for t in range(n):
        lu = int(rng.integers(5, maxlen))
        u = rng.integers(0, 4, lu).astype(np.uint8)
        v = []
        i = 0
        while i < lu:
            r = rng.random()
            if r < identity:
                v.append(u[i])
                i += 1
            elif r < identity + 0.05:
                v.append(rng.integers(0, 4))
                i += 1
            elif r < identity + 0.10:
                i += 1
            else:
                v.append(rng.integers(0, 4))
        v = np.asarray(v, np.uint8)[:maxlen]
        if v.size == 0:
            v = rng.integers(0, 4, 3).astype(np.uint8)
        if wildcards and t % 5 == 0:
            u[rng.integers(0, u.size)] = 254
        us.append(u)
        vs.append(v)
    return us, vs


# (W, D, GENS, belowscore, identity): the later cases leave lanes unsafe
# at the slot edge and at the generation cap
@pytest.mark.parametrize("case", [(128, 16, 96, 7, 0.85),
                                  (128, 4, 96, 4, 0.9),
                                  (256, 32, 8, 7, 0.95)])
def test_plain_matches_pallas_interpret(case):
    from genometools_tpu.ops.xdrop_pallas import (pack_xdrop_tasks,
                                                   xdrop_full_pallas)
    W, D, GENS, bs, ident = case
    rng = np.random.default_rng(W + D + GENS)
    us, vs = _tasks(rng, 48, W - 2, ident)
    PK = pack_xdrop_tasks(us, vs, W)
    ref = xdrop_full_pallas(PK, bs, W, D=D, GENS=GENS, interpret=True)
    # every other lane read from the reversed planes
    gp, desc = _lanes(us, vs, 0, np.arange(len(us)) % 2 == 1)
    got, _ = txf.xdrop_full(gp, *desc[:5], bs, ((W, GENS),), D)
    assert np.array_equal(ref, got[:4].numpy())
    assert (got[4] == 0).all()


def _scalar(u, v, bs):
    from genometools_tpu.ops.xdrop import xdrop_extend
    b = xdrop_extend(u, v, bs)
    return b.ivalue, b.jvalue, b.score


def _case(name, rng, n=24):
    """Flank pairs of one behaviour the reference's filters sent to the
    host (flanks of 200-600 against a first window of 128, D = 16)."""
    us, vs = [], []
    for t in range(n):
        L = int(rng.integers(200, 600))
        u = rng.integers(0, 4, L).astype(np.uint8)
        # a run of wildcards, where every front dies (on random DNA the
        # unit scores keep a front alive)
        gap = np.full(L, WILD, np.uint8)
        if name == "dies_before_clip":
            # homologous for 20-60 symbols
            v = np.concatenate([mutate(rng, u[:int(rng.integers(20, 60))],
                                       0.05, 0), gap])
        elif name == "reaches_clip":
            v = mutate(rng, u, rng.uniform(0.0, 0.06), 0)
        elif name == "offband":
            # the end diagonal lies 40-200 beyond the band
            v = np.concatenate([mutate(rng, u[:100], 0.05, 0), gap,
                                gap[:int(rng.integers(40, 200))]])
        else:
            # slot_edge: unrelated flanks, on which the front lives on and
            # spreads over the band
            v = rng.integers(0, 4, L).astype(np.uint8)
        us.append(u)
        vs.append(v)
    return us, vs


@pytest.mark.parametrize("name", ["dies_before_clip", "reaches_clip",
                                  "offband", "slot_edge"])
def test_filtered_lanes_match_scalar(name):
    """Lane by lane: every lane the plain version calls safe equals the
    scalar engine and, where the lax twin also calls it safe, the twin;
    each case shows its route (tier 0 in the clipped window, tier 1
    after the clip, safe beyond the band, unsafe at the slot edge)."""
    from genometools_tpu.ops.xdrop_batch import _run_device
    rng = np.random.default_rng(len(name))
    us, vs = _case(name, rng)
    gp, desc = _lanes(us, vs, 0, rng.integers(0, 2, len(us)))
    tiers = ((128, 128), (1024, 1024))
    out, _ = txf.xdrop_full(gp, *desc[:5], 7, tiers, 16)
    out = out.numpy()
    safe = out[3] == 0
    ti, tj, ts, tun = _run_device(us, vs, 7, 1024, 64)
    for i in np.flatnonzero(safe):
        got = tuple(int(x) for x in out[:3, i])
        assert got == _scalar(us[i], vs[i], 7), (name, i)
        if not tun[i]:
            assert got == (ti[i], tj[i], ts[i]), (name, i)
    longest = np.asarray([max(len(u), len(v)) for u, v in zip(us, vs)])
    assert (longest > 128).all()
    if name == "dies_before_clip":
        assert safe.all() and (out[4] == 0).all()
    elif name == "reaches_clip":
        assert safe.all() and (out[4] == 1).any()
    elif name == "offband":
        dif = np.abs([len(u) - len(v) for u, v in zip(us, vs)])
        assert safe.all() and (dif > 16).all()
    else:
        assert (~safe).sum() >= len(us) // 2


def test_batch_takes_filtered_lanes():
    """The batch at its own tiers takes lanes longer than 512 and lanes
    beyond the band, equal to the scalar engine lane by lane."""
    rng = np.random.default_rng(31)
    us, vs = [], []
    for name in ("dies_before_clip", "offband", "slot_edge"):
        a, b = _case(name, rng, 8)
        us += a
        vs += b
    for L in (700, 900):                   # fronts past the first tier
        u = rng.integers(0, 4, L).astype(np.uint8)
        us.append(u)
        vs.append(mutate(rng, u, 0.02, 0))
    txb.reset_stats()
    iv, jv, sv = txb.xdrop_extend_batch_exact(us, vs, 7, device="cpu")
    for i, (u, v) in enumerate(zip(us, vs)):
        assert (iv[i], jv[i], sv[i]) == _scalar(u, v, 7), i
    assert txb.stats["kernel_lanes"] + txb.stats["host_lanes"] == len(us)
    assert txb.stats["long_lanes"] > 0 and txb.stats["offband_lanes"] > 0
    assert txb.stats["tier_lanes"][1] > 0


def test_pool_batch_matches_reference_and_scalar(monkeypatch):
    from genometools_tpu.ops.xdrop import xdrop_extend
    from genometools_tpu.ops.xdrop_batch import xdrop_extend_batch_pool
    monkeypatch.setenv("GT_TPU_PALLAS_XDROP", "interpret")
    rng = np.random.default_rng(17)
    us, vs = _tasks(rng, 30, 300, 0.9)
    # one lane beyond the 512 tier and one far off the diagonal band
    us.append(rng.integers(0, 4, 600).astype(np.uint8))
    vs.append(us[-1].copy())
    us.append(rng.integers(0, 4, 100).astype(np.uint8))
    vs.append(np.concatenate([us[-1], rng.integers(0, 4, 60)])
              .astype(np.uint8))
    pool = np.concatenate(us + vs)
    lu = np.asarray([len(u) for u in us], np.int64)
    lv = np.asarray([len(v) for v in vs], np.int64)
    uo = np.cumsum(lu) - lu
    vo = lu.sum() + np.cumsum(lv) - lv
    rv = rng.integers(0, 2, len(us)).astype(bool)
    ref = xdrop_extend_batch_pool(pool, uo, lu, vo, lv, rv, 7)
    txb.reset_stats()
    got = txb.xdrop_extend_batch_pool(pool, uo, lu, vo, lv, rv, 7,
                                      device="cpu")
    for r, g in zip(ref, got):
        assert np.array_equal(r, g)
    assert txb.stats["kernel_lanes"] + txb.stats["host_lanes"] == len(us)
    # K3 takes the lane beyond 512 and the one beyond the band
    assert txb.stats["long_lanes"] >= 1 and txb.stats["offband_lanes"] >= 1
    for i in range(len(us)):
        u, v = pool[uo[i]:uo[i] + lu[i]], pool[vo[i]:vo[i] + lv[i]]
        if rv[i]:
            u, v = u[::-1], v[::-1]
        b = xdrop_extend(u, v, 7)
        assert (got[0][i], got[1][i], got[2][i]) == \
            (b.ivalue, b.jvalue, b.score), i


def test_array_batch_matches_scalar():
    from genometools_tpu.ops.xdrop import xdrop_extend
    rng = np.random.default_rng(23)
    us, vs = _tasks(rng, 40, 200, 0.8)
    iv, jv, sv = txb.xdrop_extend_batch_exact(us, vs, 5, device="cpu")
    for t in range(len(us)):
        b = xdrop_extend(us[t], vs[t], 5)
        assert (iv[t], jv[t], sv[t]) == (b.ivalue, b.jvalue, b.score), t


# (scores, quantum, half, belowscore): ltrharvest's and tirvish's default
# scores (quantum 4), doubled (quantum 8, half 2), each at a small
# belowscore and at the largest the kernel's ring takes
QSCORES = [((2, -2, -3, -3), 4, 1, 5), ((2, -2, -3, -3), 4, 1, 254),
           ((4, -4, -6, -6), 8, 2, 9), ((4, -4, -6, -6), 8, 2, 509)]


@pytest.mark.parametrize("case", QSCORES)
def test_plain_quantum_matches_scalar(case):
    """xdrop_full_plain at another quantum and half equals the scalar
    engine with those scores lane by lane (the lanes it calls safe), and
    the batch equals it on every lane; one above the ring bound raises."""
    from genometools_tpu.ops.xdrop import XdropScores, xdrop_extend
    sc, quantum, half, bs = case
    scores = XdropScores(*sc)
    assert scores.distances() == (1, 1, 1, quantum, 2 * half)
    assert bs <= txf.max_belowscore(quantum, half)
    rng = np.random.default_rng(quantum + bs)
    us, vs = _tasks(rng, 40, 300, 0.85)
    a, b = _case("reaches_clip", rng, 8)
    us, vs = us + a, vs + b
    gp, desc = _lanes(us, vs, 0, rng.integers(0, 2, len(us)))
    tiers = ((128, 128), (1024, 1024))
    out, _ = txf.xdrop_full(gp, *desc[:5], bs, tiers, 16, quantum=quantum,
                            half=half)
    out = out.numpy()
    safe = np.flatnonzero(out[3] == 0)
    assert safe.size > 0
    for i in safe:
        ref = xdrop_extend(us[i], vs[i], bs, scores)
        assert tuple(int(x) for x in out[:3, i]) == \
            (ref.ivalue, ref.jvalue, ref.score), i
    with pytest.raises(ValueError):
        txf.xdrop_full(gp, *desc[:5], txf.max_belowscore(quantum, half) + 1,
                       tiers, 16, quantum=quantum, half=half)
    from genometools_torch.ops.xdrop import XdropScores as TScores
    txb.reset_stats()
    iv, jv, sv = txb.xdrop_extend_batch_exact(us, vs, bs, TScores(*sc),
                                              device="cpu")
    assert txb.stats["kernel_lanes"] + txb.stats["host_lanes"] == len(us)
    for i, (u, v) in enumerate(zip(us, vs)):
        ref = xdrop_extend(u, v, bs, scores)
        assert (iv[i], jv[i], sv[i]) == (ref.ivalue, ref.jvalue,
                                         ref.score), i


def test_batch_non_unit_scores_take_scalar_route():
    """Scores whose unit distances are not (1, 1, 1) (tirvish -mis -1)
    run every lane on the scalar engine, equal to the reference's."""
    from genometools_tpu.ops.xdrop import XdropScores, xdrop_extend
    from genometools_torch.ops.xdrop import XdropScores as TScores
    sc = (2, -1, -3, -3)
    assert XdropScores(*sc).distances()[:3] != (1, 1, 1)
    rng = np.random.default_rng(41)
    us, vs = _tasks(rng, 24, 150, 0.85)
    txb.reset_stats()
    iv, jv, sv = txb.xdrop_extend_batch_exact(us, vs, 5, TScores(*sc),
                                              device="cpu")
    assert txb.stats["scalar_lanes"] == len(us)
    assert txb.stats["kernel_lanes"] == 0
    for i, (u, v) in enumerate(zip(us, vs)):
        ref = xdrop_extend(u, v, 5, XdropScores(*sc))
        assert (iv[i], jv[i], sv[i]) == (ref.ivalue, ref.jvalue,
                                         ref.score), i


# (scores, the largest belowscore K3's ring takes at their quantum)
RING = [((2, -1, -2, -2), 190), ((2, -2, -3, -3), 254),
        ((4, -4, -6, -6), 509)]


@pytest.mark.parametrize("case", RING)
def test_batch_refuses_belowscore_beyond_ring(case):
    """Unit-distance scores go to K3, which takes no belowscore beyond
    its ring: the batch raises there, with lanes or without, and sends
    no lane to the host; non-unit scores take the scalar route at any
    belowscore."""
    from genometools_tpu.ops.xdrop import XdropScores, xdrop_extend
    from genometools_torch.ops.xdrop import XdropScores as TScores
    sc, top = case
    q, m2 = TScores(*sc).distances()[3:]
    assert txf.max_belowscore(q, m2 // 2) == top
    rng = np.random.default_rng(top)
    us, vs = _tasks(rng, 8, 100, 0.85)
    txb.reset_stats()
    for lanes in ((us, vs), ([], [])):
        with pytest.raises(ValueError):
            txb.xdrop_extend_batch_exact(*lanes, top + 1, TScores(*sc),
                                         device="cpu")
    assert txb.stats["scalar_lanes"] == txb.stats["host_lanes"] == 0
    wide = (sc[0], sc[1] + 1, sc[2], sc[3])
    assert TScores(*wide).distances()[:3] != (1, 1, 1)
    iv, jv, sv = txb.xdrop_extend_batch_exact(us, vs, top + 1,
                                              TScores(*wide), device="cpu")
    assert txb.stats["scalar_lanes"] == len(us)
    for i, (u, v) in enumerate(zip(us, vs)):
        ref = xdrop_extend(u, v, top + 1, XdropScores(*wide))
        assert (iv[i], jv[i], sv[i]) == (ref.ivalue, ref.jvalue,
                                         ref.score), i


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# (tiers, D, lanes): the main path's tiers and band over several times
# the card's resident warps, so every persistent warp takes several lanes
# from the queue (long, off-band and clipped lanes among them); single
# tiers of 256 and 512 at the reference's band D = 32; then a narrow band
# and a tiny generation cap that leave lanes unsafe
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(txb.TIERS, txb.D_BAND, 20000),
                                   (((256, 512),), 32, 400),
                                   (((512, 512),), 32, 400),
                                   (((256, 96),), 4, 400),
                                   (((256, 8), (512, 16)), 32, 400)])
def test_cuda_kernel_matches_plain(cuda_device, shape):
    tiers, D, n = shape
    rng = np.random.default_rng(D + n)
    us, vs = _tasks(rng, n // 2, 250, 0.85)
    for name in ("dies_before_clip", "reaches_clip", "offband",
                 "slot_edge"):
        a, b = _case(name, rng, n // 8)
        us += a
        vs += b
    gp, desc = _lanes(us, vs, 0, rng.integers(0, 2, len(us)),
                      device=cuda_device)
    cnt = {}
    plain = txf.xdrop_full_plain(gp, *desc[:5], 7, tiers, D, counts=cnt)
    kern, slot_gens = txf.xdrop_full(gp, *desc[:5], 7, tiers, D)
    torch.cuda.synchronize()
    assert torch.equal(plain, kern)
    assert int(slot_gens) == cnt["slot_gens"]
    if tiers == txb.TIERS:
        # lanes past the first tier's clip and beyond the reference's band
        taken = plain[3] == 0
        assert int((taken & (plain[4] > 0)).sum()) > 0
        assert int((taken & ((desc[1] - desc[3]).abs() > 32)).sum()) > 0
    else:
        assert int(plain[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", QSCORES[:3])
def test_cuda_kernel_quantum_matches_plain(cuda_device, case):
    """K3 at another quantum and half against its plain version, on the
    main path's tiers and band, with lanes of every kind."""
    _, quantum, half, bs = case
    rng = np.random.default_rng(quantum + bs)
    us, vs = _tasks(rng, 4000, 250, 0.85)
    for name in ("dies_before_clip", "reaches_clip", "offband",
                 "slot_edge"):
        a, b = _case(name, rng, 500)
        us += a
        vs += b
    gp, desc = _lanes(us, vs, 0, rng.integers(0, 2, len(us)),
                      device=cuda_device)
    cnt = {}
    kq = dict(quantum=quantum, half=half)
    plain = txf.xdrop_full_plain(gp, *desc[:5], bs, txb.TIERS, txb.D_BAND,
                                 counts=cnt, **kq)
    kern, slot_gens = txf.xdrop_full(gp, *desc[:5], bs, txb.TIERS,
                                     txb.D_BAND, **kq)
    torch.cuda.synchronize()
    assert torch.equal(plain, kern)
    assert int(slot_gens) == cnt["slot_gens"]
