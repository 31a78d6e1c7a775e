"""The packed-bootstrap pipeline of genometools_torch/index/suffix.py
against the reference's (JAX on the CPU): each stage at sigma 4 and 20,
the whole pipeline, the routing between the two engines, and the device
certificate of (sa, lcp). Keys are made with numpy from a seed;
comparisons are exact (integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genometools_tpu.index import suffix as ref
from genometools_torch.index import suffix as port

torch.set_num_threads(1)

M30 = (1 << 30) - 1


def _keys(case: str, seed: int = 5) -> np.ndarray:
    """Canonical suffix keys (special at p -> sigma + p, sentinel last)."""
    rng = np.random.default_rng(seed)
    sigma = 20 if case == "protein" else 4
    n = {"n1_1": 0, "n1_2": 1}.get(case, 2500)
    k = rng.integers(0, sigma, n + 1)
    if case == "tandem":
        # repeats far longer than m: several refinement rounds and deep
        # lcp pairs
        unit = rng.integers(0, 4, 37)
        k = np.tile(unit, n // 37 + 2)[:n + 1]
        k[1200:1300] = rng.integers(0, 4, 100)
    elif case == "single_symbol":
        k[:] = 2
    sp = []
    if case in ("dna", "protein", "tandem"):
        sp = rng.choice(n, n // 50, replace=False)
    elif case == "special_runs":
        sp = np.concatenate([np.arange(s, s + 40)
                             for s in range(100, n - 100, 300)])
    k[sp] = sigma + np.asarray(sp, np.int64)
    k[n] = sigma + n
    return k.astype(np.int32)


def _stage_keys(sigma: int) -> np.ndarray:
    """Random keys with specials and a repeated block, so the bootstrap
    leaves ties and some pairs are deep."""
    k = _keys("protein" if sigma == 20 else "dna", seed=sigma)
    k[1500:1800] = np.where(k[200:500] < sigma, k[200:500], 1)
    k[1800:1810] = 0
    return k


def _stages(sigma):
    keys = _stage_keys(sigma)
    b, per_hi, per_lo, m = port._pack_plan(sigma)
    assert (b, per_hi, per_lo, m) == ref._pack_plan(sigma)
    n1 = keys.size
    keysx = np.concatenate([keys, sigma + n1 + np.arange(m, dtype=np.int32)])
    return keys, keysx, (b, per_hi, per_lo, m)


@pytest.mark.parametrize("sigma", [4, 20])
def test_pack_windows_matches_reference(sigma):
    keys, keysx, (b, per_hi, per_lo, m) = _stages(sigma)
    rhi, rlo = ref._pack_windows(jnp.asarray(keysx), b, per_hi, per_lo,
                                 sigma)
    hi, lo = port._pack_windows(torch.from_numpy(keysx), b, per_hi, per_lo,
                                sigma)
    assert np.array_equal(np.asarray(rhi), hi.numpy())
    assert np.array_equal(np.asarray(rlo), lo.numpy())
    words = port._packed_words(torch.from_numpy(keys), sigma)
    assert np.array_equal(words.numpy(), (np.asarray(rhi, np.int64) << 30)
                          | np.asarray(rlo, np.int64))


@pytest.mark.parametrize("sigma", [4, 20])
def test_bootstrap_refine_and_lcp_base_match_reference(sigma):
    """_bootstrap_rank (ranks, tied mask, count, sorted words), one
    _refine_subset round and _lcp_base, each on the same inputs as the
    reference's jitted stage."""
    keys, keysx, (b, per_hi, per_lo, m) = _stages(sigma)
    n1 = keys.size
    rhi, rlo = ref._pack_windows(jnp.asarray(keysx), b, per_hi, per_lo,
                                 sigma)
    rrank, rtied, rcount, shi, slo = ref._bootstrap_rank(rhi, rlo, m)
    words = port._packed_words(torch.from_numpy(keys), sigma)
    rank, tied, count, swords = port._bootstrap_rank(words, m)
    assert np.array_equal(np.asarray(rrank), rank.numpy())
    assert np.array_equal(np.asarray(rtied), tied.numpy())
    assert count == int(rcount) > 0
    assert np.array_equal(np.asarray(shi), (swords >> 30).numpy())
    assert np.array_equal(np.asarray(slo), (swords & M30).numpy())
    # windows equal up to their first special sit in position order
    # (the reference's tb key), each a group of its own
    twins = (swords[1:] == swords[:-1]) & ((swords[1:] & 31) < m)
    assert int(twins.sum()) > 10

    s = np.flatnonzero(np.asarray(rtied)).astype(np.int32)
    rrank2, rss, rstill = ref._refine_subset(
        rrank, jnp.asarray(s), jnp.ones(s.size, bool), jnp.int32(m))
    still = port._refine_subset(rank, torch.from_numpy(s), m)
    assert np.array_equal(np.asarray(rrank2), rank.numpy())
    assert sorted(np.asarray(rss)[np.asarray(rstill)].tolist()) == \
        sorted(still.tolist())

    rlcp, rdeep, rdc = ref._lcp_base(shi, slo, b, per_hi, per_lo, n1)
    lcp, deep = port._lcp_base(swords >> 30, swords & M30, b, per_hi, per_lo)
    assert np.array_equal(np.asarray(rlcp), lcp.numpy())
    assert np.array_equal(np.asarray(rdeep), deep.numpy())
    assert int(deep.sum()) == int(rdc) > 0


CASES = ["dna", "protein", "special_runs", "tandem", "single_symbol",
         "n1_1", "n1_2"]


@pytest.mark.parametrize("case", CASES)
def test_pipeline_matches_reference(case, spans):
    keys = _keys(case)
    rsa, rlcp = ref.build_suffix_array(keys)
    sa, lcp = port.build_suffix_array(keys, device="cpu")
    recs = {r.name: r for r in spans()}
    assert recs["esa.route"].attrs["engine"] == "packed"
    assert sa.dtype == lcp.dtype == torch.int32
    assert np.array_equal(np.asarray(rsa), sa.numpy())
    assert np.array_equal(np.asarray(rlcp), lcp.numpy())
    assert [r.name for r in spans()] == [
        "esa.upload", "esa.route", "esa.pack", "esa.bootstrap_sort",
        "esa.refine", "esa.sa_scatter", "esa.lcp_base", "esa.lcp_deep"]
    tied = recs["esa.refine"].attrs["tied"]
    assert recs["esa.refine"].attrs["rounds"] == len(tied) - 1
    if case in ("tandem", "single_symbol"):
        # rounds until none is tied; lcp >= m pairs took the descent
        assert len(tied) > 2 and tied[-1] == 0
        assert recs["esa.lcp_deep"].attrs["deep"] > 0
    sa_only, none = port.build_suffix_array(keys, with_lcp=False,
                                            device="cpu")
    assert none is None and torch.equal(sa_only, sa)


@pytest.mark.parametrize("case", ["tandem", "special_runs"])
def test_pipeline_chunk_boundaries(case, monkeypatch):
    """Full-length stages run in chunks (_CHUNK entries; 2^26 on the card):
    tiny chunks give the same (sa, lcp) and certificate."""
    monkeypatch.setattr(port, "_CHUNK", 61)
    keys = _keys(case)
    rsa, rlcp = ref.build_suffix_array(keys)
    sa, lcp = port.build_suffix_array(keys, device="cpu")
    assert np.array_equal(np.asarray(rsa), sa.numpy())
    assert np.array_equal(np.asarray(rlcp), lcp.numpy())
    assert port.check_sa_lcp(torch.from_numpy(keys), sa, lcp, direct=8)


def test_routing_canonical_to_pipeline_others_to_doubling(monkeypatch):
    calls = []

    def spy(name, fn):
        def run(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(port, "_sa_pipeline",
                        spy("packed", port._sa_pipeline))
    monkeypatch.setattr(port, "doubling_sa_lcp",
                        spy("doubling", port.doubling_sa_lcp))
    canon = _keys("dna")
    other = canon.copy()
    other[np.random.default_rng(3).choice(other.size - 1, 40,
                                          replace=False)] = 253
    for keys, engine in ((canon, "packed"), (other, "doubling"),
                         (_keys("tandem"), "packed")):
        calls.clear()
        rsa, rlcp = ref.build_suffix_array(keys)
        sa, lcp = port.build_suffix_array(keys, device="cpu")
        assert calls == [engine]
        assert np.array_equal(np.asarray(rsa), sa.numpy())
        assert np.array_equal(np.asarray(rlcp), lcp.numpy())


def test_tensor_keys_match_host_oracles():
    """Keys given as a tensor (build_suffix_array takes a numpy array
    or a tensor) against the brute-force sort and Kasai."""
    keys = torch.from_numpy(_keys("dna"))
    sa, lcp = port.build_suffix_array(keys, device="cpu")
    ref_sa = port.suffix_array_bruteforce(keys.numpy())
    assert np.array_equal(ref_sa, sa.numpy())
    assert np.array_equal(port.kasai_lcp(keys.numpy(), ref_sa), lcp.numpy())


@pytest.mark.parametrize("case", ["tandem", "dna"])
def test_certificate_accepts_truth_rejects_faults(case):
    keys = _keys(case)
    sa, lcp = port.build_suffix_array(keys, device="cpu")
    k = torch.from_numpy(keys)
    assert port.check_sa_lcp(k, sa, lcp)
    assert port.check_sa_lcp(k, sa, lcp, direct=4)      # the long loop
    assert port.check_suftab_order(keys, sa.numpy())
    i = int(torch.nonzero(lcp > 0)[len(lcp) // 3])
    swapped = sa.clone()
    swapped[[i - 1, i]] = swapped[[i, i - 1]]
    assert not port.check_sa_lcp(k, swapped, lcp)
    for delta in (1, -1):
        off = lcp.clone()
        off[i] += delta
        assert not port.check_sa_lcp(k, sa, off)
        assert not port.check_sa_lcp(k, sa, off, direct=4)
    dup = sa.clone()
    dup[0] = dup[1]
    assert not port.check_sa_lcp(k, dup, lcp)
