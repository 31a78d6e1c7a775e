"""genometools_torch.parallel against the reference package on the CPU.

The port runs on meshes of CPU shards (``Mesh([cpu] * P)``), the
reference on the conftest's eight virtual JAX devices, on the same
inputs made from numpy seeds at test_parallel.py's sizes. Suffix arrays,
LCPs, counts, pairs and seed_extend lines must be exactly equal. Also:
the mesh's collectives and its stable multi-column sort against numpy,
the wide route of build_suffix_array, build_esa and the CLI on a mesh,
the thread-safe kernel loader and launch counters, and the dry run."""

import contextlib
import io
import threading

import numpy as np
import pytest
import torch

from genometools_torch.core.encseq import Encseq
from genometools_torch.parallel.mesh import (Mesh, all_gather, all_to_all,
                                             axis_index, lexsort, pmax,
                                             ppermute, psum)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _mesh(P=8):
    return Mesh([CPU] * P)


def _ref_mesh(P=8):
    from genometools_tpu.parallel.dist_esa import make_mesh
    return make_mesh(P)


def _dna(seed, n, alphabet="acgtn", p=(0.24,) * 4 + (0.04,)):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list(alphabet), n, p=p if len(alphabet) == 5
                              else None))


def _keys(s):
    return Encseq.from_string(s).suffix_keys()


def _padded(s, ndev=8):
    """Suffix keys padded to a multiple of ndev (test_parallel.py's
    _keys_padded)."""
    keys = _keys(s)
    n1 = keys.size
    npad = -(-n1 // ndev) * ndev
    pad = keys.max() + 1 + np.arange(npad - n1, dtype=np.int32)
    return np.concatenate([keys, pad]).astype(np.int32), n1, npad


# ---------------------------------------------------------------------------
# the mesh: collectives and lexsort against numpy
# ---------------------------------------------------------------------------

class TestMesh:
    def test_collectives(self):
        rng = np.random.default_rng(0)
        P, K = 4, 3
        blocks = [torch.from_numpy(rng.integers(0, 100, P * K))
                  for _ in range(P)]
        a2a = all_to_all(blocks)
        for j in range(P):
            want = np.concatenate([b.numpy()[j * K:(j + 1) * K]
                                   for b in blocks])
            assert a2a[j].tolist() == want.tolist()
        # tiled all_to_all is an involution
        assert [x.tolist() for x in all_to_all(a2a)] == \
            [b.tolist() for b in blocks]
        perm = [(i, (i + 1) % P) for i in range(P - 1)]
        pp = ppermute(blocks, perm)
        assert pp[0].tolist() == [0] * (P * K)
        for i, j in perm:
            assert pp[j].tolist() == blocks[i].tolist()
        s = psum(blocks)
        total = np.sum([b.numpy() for b in blocks], axis=0)
        assert all(x.tolist() == total.tolist() for x in s)
        g = all_gather([b[:2] for b in blocks])
        assert all(x.tolist() == [b[:2].tolist() for b in blocks] for x in g)
        mx = pmax(blocks)
        assert mx[1].tolist() == np.max([b.numpy() for b in blocks],
                                        axis=0).tolist()
        assert [int(i) for i in axis_index(_mesh(P))] == list(range(P))

    @pytest.mark.parametrize("case", ["narrow", "wide", "constant", "bool",
                                      "empty"])
    def test_lexsort_matches_numpy(self, case):
        rng = np.random.default_rng(3)
        n = 0 if case == "empty" else 2000
        if case == "wide":
            cols = [rng.integers(-2 ** 62, 2 ** 62, n),
                    rng.integers(0, 3, n), rng.integers(-5, 2 ** 40, n)]
        elif case == "constant":
            cols = [np.full(n, 7), rng.integers(0, 4, n)]
        elif case == "bool":
            cols = [rng.integers(0, 2, n).astype(bool),
                    rng.integers(0, 9, n).astype(np.int32)]
        else:
            cols = [rng.integers(0, 5, n), rng.integers(-3, 3, n),
                    rng.integers(0, 1 << 20, n).astype(np.int32)]
        payload = np.arange(n)
        got = lexsort([torch.from_numpy(c) for c in cols] +
                      [torch.from_numpy(payload)], len(cols))
        # np.lexsort: last key most significant, stable
        order = np.lexsort(cols[::-1])
        assert got[-1].tolist() == payload[order].tolist()
        for g, c in zip(got, cols):
            assert g.tolist() == c[order].tolist()


# ---------------------------------------------------------------------------
# test_parallel.py's classes
# ---------------------------------------------------------------------------

class TestShardedPipeline:
    def test_histogram(self):
        import jax.numpy as jnp
        from genometools_tpu.parallel.dist_esa import sharded_kmer_histogram \
            as ref_hist

        from genometools_torch.parallel.dist_esa import \
            sharded_kmer_histogram
        keys, n1, npad = _padded("acgtacgtnn|ggg")
        got = sharded_kmer_histogram(keys, npad, _mesh())
        want = ref_hist(jnp.asarray(keys), npad, _ref_mesh())
        assert got.tolist() == np.asarray(want).tolist()
        assert int(got.sum()) == npad

    def test_sharded_sort_matches_single(self):
        import jax.numpy as jnp
        from genometools_tpu.parallel.dist_esa import sharded_suffix_sort \
            as ref_sort

        from genometools_torch.index.suffix import build_suffix_array
        from genometools_torch.parallel.dist_esa import sharded_suffix_sort
        keys, n1, npad = _padded(_dna(0, 301))
        sa, hist = sharded_suffix_sort(keys, npad, 32, _mesh())
        rsa, rhist = ref_sort(jnp.asarray(keys), npad, 32, _ref_mesh())
        single = build_suffix_array(keys, with_lcp=False, device="cpu")[0]
        assert sa.tolist() == np.asarray(rsa).tolist() == single.tolist()
        assert hist.tolist() == np.asarray(rhist).tolist()


class TestDistributedDoubling:
    def _check(self, s):
        import jax.numpy as jnp
        from genometools_tpu.parallel.dist_doubling import \
            distributed_build_sa as ref_dbsa

        from genometools_torch.parallel.dist_doubling import \
            distributed_build_sa
        keys, n1, npad = _padded(s)
        got = distributed_build_sa(keys, npad, _mesh())
        want = ref_dbsa(jnp.asarray(keys), npad, _ref_mesh())
        assert got.tolist() == np.asarray(want).tolist()

    @pytest.mark.parametrize("seed", range(3))
    def test_matches_reference(self, seed):
        self._check(_dna(seed, 500))

    def test_repetitive(self):
        self._check("acg" * 120)


class TestShardedDoubling:
    @pytest.mark.parametrize("n", [16, 253, 1000, 4096])
    def test_matches_reference(self, n):
        from genometools_tpu.parallel.dist_doubling_sharded import \
            sharded_suffix_array as ref_ssa

        from genometools_torch.parallel.dist_doubling_sharded import \
            sharded_suffix_array
        keys = _keys(_dna(n, n))
        want = ref_ssa(keys, _ref_mesh())
        for P in (1, 2, 4, 8):
            got = sharded_suffix_array(keys, _mesh(P))
            assert got.tolist() == want.tolist(), P

    def test_repetitive_no_skew_sensitivity(self):
        from genometools_tpu.parallel.dist_doubling_sharded import \
            sharded_suffix_array as ref_ssa

        from genometools_torch.parallel.dist_doubling_sharded import \
            sharded_suffix_array
        keys = _keys("acg" * 1000 + "t")
        assert sharded_suffix_array(keys, _mesh()).tolist() == \
            ref_ssa(keys, _ref_mesh()).tolist()

    @pytest.mark.parametrize("ndev", [1, 2, 4])
    def test_smaller_meshes(self, ndev):
        from genometools_tpu.parallel.dist_doubling_sharded import \
            sharded_suffix_array as ref_ssa

        from genometools_torch.parallel.dist_doubling_sharded import \
            sharded_suffix_array
        keys = _keys("mississippimississippi|acgtacgt")
        assert sharded_suffix_array(keys, _mesh(ndev)).tolist() == \
            ref_ssa(keys, _ref_mesh(ndev)).tolist()


def _pow2_padded(s):
    """test_parallel.py's sample-engine inputs: keys padded to a power of
    two (at least 8)."""
    keys = _keys(s)
    n1 = keys.size
    npad = 1 << max(3, (n1 - 1).bit_length())
    pad = keys.max() + 1 + np.arange(npad - n1, dtype=np.int32)
    return np.concatenate([keys, pad]).astype(np.int32), n1, npad


class TestSampleSortExchange:
    def _check(self, s):
        import jax.numpy as jnp
        from genometools_tpu.parallel.dist_doubling_sharded import \
            sharded_build_sa_sample as ref_sample

        from genometools_torch.parallel.dist_doubling_sharded import \
            sharded_build_sa_sample
        from genometools_torch.parallel.mesh import gather
        keysp, n1, npad = _pow2_padded(s)
        sa, ovf = sharded_build_sa_sample(torch.from_numpy(keysp), npad,
                                          _mesh())
        rsa, rovf = ref_sample(jnp.asarray(keysp), npad, _ref_mesh())
        assert ovf == 0 == int(np.asarray(rovf))
        assert gather(sa)[:n1].tolist() == np.asarray(rsa)[:n1].tolist()

    @pytest.mark.parametrize("seed", range(4))
    def test_sample_engine_no_overflow_on_random(self, seed):
        rng = np.random.default_rng(seed)
        self._check(_dna(seed, int(rng.integers(300, 3000))))

    @pytest.mark.parametrize("text", ["a" * 1200, "acg" * 500,
                                      "a" * 600 + "c" * 600])
    def test_pathological_skew_no_overflow(self, text):
        self._check(text)

    def test_bitonic_engine_still_exact(self):
        from genometools_tpu.parallel.dist_doubling_sharded import \
            sharded_suffix_array as ref_ssa

        from genometools_torch.parallel.dist_doubling_sharded import \
            sharded_suffix_array
        keys = _keys(_dna(11, 700, "acgt"))
        got = sharded_suffix_array(keys, _mesh(), engine="bitonic")
        assert got.tolist() == ref_ssa(keys, _ref_mesh(),
                                       engine="bitonic").tolist()


class TestDistSeedGrid:
    def test_grid_counts_match_reference(self):
        from genometools_tpu.core.encseq import Encseq as RefEncseq
        from genometools_tpu.match.seed_extend import \
            enumerate_kmers as ref_kmers
        from genometools_tpu.parallel.dist_seed_grid import \
            grid_mlistlen as ref_grid

        from genometools_torch.match.seed_extend import (enumerate_kmers,
                                                         sequence_ranges)
        from genometools_torch.parallel.dist_seed_grid import grid_mlistlen
        rng = np.random.default_rng(2)
        text = "|".join("".join(rng.choice(list("acgt"),
                                           rng.integers(80, 300)))
                        for _ in range(9))
        e = Encseq.from_string(text)
        alist = enumerate_kmers(e, 8, revcomp=False)
        ralist = ref_kmers(RefEncseq.from_string(text), 8, revcomp=False)
        assert all(np.array_equal(a, b) for a, b in zip(alist, ralist))
        aranges = sequence_ranges(e, 3)
        blists = []
        for lo, hi in aranges:
            m = (alist[1] >= lo) & (alist[1] <= hi)
            blists.append((alist[0][m], alist[1][m], alist[2][m]))
        got = grid_mlistlen(alist, blists, aranges, _mesh(), selfcomp=True)
        want = ref_grid(alist, blists, aranges, _ref_mesh(), selfcomp=True)
        assert got.tolist() == want.tolist() and got.sum() > 0
        # a comparison of two sets: every (a, b) cell
        got2 = grid_mlistlen(alist, blists, aranges, _mesh(3),
                             selfcomp=False)
        want2 = ref_grid(alist, blists, aranges, _ref_mesh(),
                         selfcomp=False)
        assert got2.tolist() == want2.tolist()


class TestPairLanes:
    """The reference's int32-pair lanes (GT_TPU_FORCE_PAIR=1, set for the
    reference only) against the port's int64 lanes."""

    @pytest.mark.parametrize("n", [40, 253, 1000])
    def test_forced_int64_matches_reference_pair(self, n, monkeypatch):
        from genometools_tpu.parallel.dist_doubling_sharded import \
            sharded_suffix_array as ref_ssa

        from genometools_torch.parallel.dist_doubling_sharded import \
            sharded_suffix_array
        keys = _keys(_dna(n + 7, n))
        monkeypatch.setenv("GT_TPU_FORCE_PAIR", "1")
        want = ref_ssa(keys, _ref_mesh())
        monkeypatch.delenv("GT_TPU_FORCE_PAIR")
        for P in (1, 8):
            got = sharded_suffix_array(keys, _mesh(P), lanes="int64")
            assert got.dtype == want.dtype == np.int64
            assert got.tolist() == want.tolist(), P

    def test_key_values_beyond_int32(self):
        # a constant added to every key keeps every suffix comparison
        from genometools_tpu.parallel.dist_doubling_sharded import \
            sharded_suffix_array as ref_ssa

        from genometools_torch.parallel.dist_doubling_sharded import \
            sharded_suffix_array
        wide = _keys(_dna(99, 700)).astype(np.int64) + (7 << 32)
        got = sharded_suffix_array(wide, _mesh())
        assert got.dtype == np.int64
        assert got.tolist() == ref_ssa(wide, _ref_mesh()).tolist()

    def test_repetitive_int64_lanes(self, monkeypatch):
        from genometools_tpu.parallel.dist_doubling_sharded import \
            sharded_suffix_array as ref_ssa

        from genometools_torch.parallel.dist_doubling_sharded import \
            sharded_suffix_array
        keys = _keys("acg" * 700 + "t")
        monkeypatch.setenv("GT_TPU_FORCE_PAIR", "1")
        want = ref_ssa(keys, _ref_mesh())
        monkeypatch.delenv("GT_TPU_FORCE_PAIR")
        assert sharded_suffix_array(keys, _mesh(), lanes="int64").tolist() \
            == want.tolist()


class TestWideRoute:
    """build_suffix_array's wide route (forced at a small size) against
    the reference's GT_TPU_WIDE_FORCE route: SA and LCP."""

    def _noncanonical(self, seed, n):
        rng = np.random.default_rng(seed)
        keys = rng.integers(0, 4, n + 1).astype(np.int32)
        for s in rng.integers(0, n - 20, 6):     # UNDEFCHAR runs
            keys[s:s + int(rng.integers(1, 12))] = 253
        keys[-1] = 4 + n
        return keys

    @pytest.mark.parametrize("case", ["canonical", "noncanonical",
                                      "repetitive"])
    def test_matches_reference(self, case, monkeypatch):
        from genometools_tpu.index.suffix import \
            build_suffix_array as ref_bsa

        from genometools_torch.index.suffix import build_suffix_array
        keys = {"canonical": lambda: _keys(_dna(5, 900)),
                "noncanonical": lambda: self._noncanonical(6, 1500),
                "repetitive": lambda: _keys("acgtt" * 300)}[case]()
        monkeypatch.setenv("GT_TPU_WIDE_FORCE", "1")
        rsa, rlcp = ref_bsa(keys)
        monkeypatch.delenv("GT_TPU_WIDE_FORCE")
        trace = {}
        sa, lcp = build_suffix_array(keys, device="cpu", engine="wide",
                                     trace=trace)
        assert trace["engine"] == "wide"
        assert sa.tolist() == np.asarray(rsa).tolist()
        assert lcp.tolist() == np.asarray(rlcp).tolist()
        # and the route the keys take by themselves
        sa2, lcp2 = build_suffix_array(keys, device="cpu")
        assert sa2.tolist() == sa.tolist() and lcp2.tolist() == lcp.tolist()

    def test_routing(self, monkeypatch):
        """Keys past int32 and non-canonical keys past the reference's
        2^30 budget take the wide route, the others keep theirs (the
        engines are stubbed: only the choice is under test)."""
        from genometools_torch.index import suffix
        taken = []
        monkeypatch.setattr(suffix, "_build_suffix_array_wide",
                            lambda k, w, t: taken.append("wide"))
        monkeypatch.setattr(suffix, "doubling_sa_lcp",
                            lambda k, w: taken.append("doubling"))
        monkeypatch.setattr(suffix, "_sa_pipeline",
                            lambda k, s, w, t: taken.append("packed"))
        n = 1000
        canon = np.concatenate([np.zeros(n, np.int64), [4 + n]])
        big = canon.copy()
        big[-1] = 2 ** 31               # non-canonical, past int32
        # 2^30 + 1 non-canonical keys (one zero, repeated: no memory)
        above = torch.zeros(1, dtype=torch.int32).expand(2 ** 30 + 1)
        for keys in (canon, big, self._noncanonical(1, n), above):
            suffix.build_suffix_array(keys, device="cpu")
        assert taken == ["packed", "wide", "doubling", "wide"]

    def test_two_to_the_31_raises(self):
        """The reference's wide route wraps positions from 2^31 on; the
        port raises there."""
        from genometools_torch.index.suffix import build_suffix_array
        keys = torch.zeros(1, dtype=torch.int32).expand(2 ** 31)
        with pytest.raises(NotImplementedError):
            build_suffix_array(keys, device="cpu")


def _se_params(mod, parts, ext="greedy"):
    return mod.SeedExtendParams(userdefinedleastlength=10, minidentity=80,
                                sensitivity=97, extension=ext, parts=parts)


def _genome(seed, n=600):
    """Six random sequences of n symbols sharing planted pieces on both
    strands."""
    rng = np.random.default_rng(seed)
    comp = str.maketrans("acgt", "tgca")
    seqs = ["".join(rng.choice(list("acgt"), n)) for _ in range(6)]
    for t in range(10):
        a, b = (int(x) for x in rng.choice(6, 2, replace=False))
        L = int(rng.integers(60, 150))
        p, q = (int(x) for x in rng.integers(0, n - L, 2))
        piece = seqs[a][p:p + L]
        if t % 2:
            piece = piece.translate(comp)[::-1]
        seqs[b] = seqs[b][:q] + piece + seqs[b][q + L:]
    return "|".join(seqs)


class TestDistributedSeedExtend:
    """The grid's cells on a mesh's lanes: the port's single-device grid
    and the reference's distributed grid, line for line."""

    def _three(self, text, parts, ndev, ext="greedy"):
        import jax
        from genometools_tpu.core.encseq import Encseq as RefEncseq
        from genometools_tpu.match import seed_extend as rse
        from genometools_tpu.parallel.dist_seed_grid import \
            distributed_seed_extend as ref_dse

        from genometools_torch.match import seed_extend as tse
        from genometools_torch.parallel.dist_seed_grid import \
            distributed_seed_extend
        e = Encseq.from_string(text)
        single = [m.line() for m in tse.seed_extend(
            e, None, _se_params(tse, parts, ext), device="cpu")]
        got = [m.line() for m in distributed_seed_extend(
            e, None, _se_params(tse, parts, ext), devices=_mesh(ndev))]
        want = [m.line() for m in ref_dse(
            RefEncseq.from_string(text), None, _se_params(rse, parts, ext),
            devices=jax.devices()[:ndev])]
        return single, got, want

    @pytest.mark.parametrize("ext,n", [("greedy", 600), ("xdrop", 250)])
    def test_selfcomp_grid_exact(self, ext, n):
        single, got, want = self._three(_genome(1, n), 4, 8, ext)
        assert got == single == want and got

    def test_two_lane_mesh_exact(self):
        single, got, want = self._three(_genome(2), 2, 2)
        assert got == single == want and got

    def test_events_order_preserved(self):
        from genometools_torch.match import seed_extend as tse
        from genometools_torch.parallel.dist_seed_grid import \
            distributed_seed_extend
        e = Encseq.from_string(_genome(3))

        def run(fn, **kw):
            ev = []
            fn(e, None, _se_params(tse, 3), events=ev, **kw)
            return [("match", x[1].line()) if x[0] == "match" else x
                    for x in ev]

        single = run(tse.seed_extend, device="cpu")
        assert single and run(distributed_seed_extend,
                              devices=_mesh(4)) == single

    def test_lane_launches_counted_per_lane(self, monkeypatch):
        """Every lane's kernel launches are counted under its tag (the
        plain versions stand in for the kernels here; the wrapper's count
        is what chip_smoke reads on the card)."""
        from genometools_torch import _kernels
        from genometools_torch.match import seed_extend as tse
        from genometools_torch.parallel import dist_seed_grid as dsg
        seen = []
        orig = tse.grid_cell_matches

        def spy(*a, **kw):
            _kernels.record_launch(counter)
            seen.append(threading.current_thread().name)
            return orig(*a, **kw)
        counter = {"launches": 0, "__name__": "spy"}
        monkeypatch.setattr(tse, "grid_cell_matches", spy)
        _kernels.lane_launches.clear()
        e = Encseq.from_string(_genome(4))
        dsg.distributed_seed_extend(e, None, _se_params(tse, 3),
                                    devices=_mesh(4))
        assert counter["launches"] == len(seen) == 6
        lanes = {lane for lane, _ in _kernels.lane_launches}
        assert lanes == {0, 1, 2, 3}
        assert sum(_kernels.lane_launches.values()) == 6


class TestDistributedReadjoiner:
    def _readsets(self, nreads=60, L=50, seed=3):
        from genometools_tpu.assembly.readjoiner import ReadSet as RefRS

        from genometools_torch.assembly.readjoiner import ReadSet
        rng = np.random.default_rng(seed)
        g = rng.integers(0, 4, 2000).astype(np.uint8)
        reads = []
        for _ in range(nreads):
            s = int(rng.integers(0, g.size - L))
            reads.append(g[s:s + L].copy())
        return ReadSet([r.copy() for r in reads]), RefRS(reads)

    def test_count_matches_reference(self):
        from genometools_tpu.parallel.dist_readjoiner import \
            sharded_spm_candidate_count as ref_count

        from genometools_torch.parallel.dist_readjoiner import \
            sharded_spm_candidate_count
        rs, rrs = self._readsets()
        for minlen in (20, 35):
            got = sharded_spm_candidate_count(rs, minlen, _mesh())
            assert got == ref_count(rrs, minlen, _ref_mesh()) > 0
            assert sharded_spm_candidate_count(rs, minlen, _mesh(3)) == got

    def test_distributed_find_spms_identical(self):
        from genometools_tpu.parallel.dist_readjoiner import \
            distributed_find_spms as ref_dfs

        from genometools_torch.assembly.readjoiner import find_spms
        from genometools_torch.parallel.dist_readjoiner import \
            distributed_find_spms
        rs, rrs = self._readsets(nreads=120, L=80, seed=9)
        got = distributed_find_spms(rs, 30, _mesh())
        assert got.lines() == find_spms(rs, 30).lines() == \
            ref_dfs(rrs, 30, _ref_mesh()).lines()
        assert got.lines()

    def test_find_spms_lanes_argument(self):
        """The native join's lane count is an argument: 1 and 4 lanes give
        the same rows."""
        from genometools_torch.assembly.readjoiner import find_spms
        rs, _ = self._readsets(nreads=300, L=80, seed=12)
        one = find_spms(rs, 30, lanes=1).lines()
        assert one and find_spms(rs, 30, lanes=4).lines() == one


class TestDistTallymerMaxpairs:
    def test_sharded_mer_counts(self):
        from genometools_tpu.parallel.dist_tallymer import \
            sharded_mer_counts as ref_counts

        from genometools_torch.parallel.dist_tallymer import \
            sharded_mer_counts
        codes = np.random.default_rng(3).integers(0, 4 ** 9, 50000)
        m, c = sharded_mer_counts(codes, 9, _mesh())
        rm, rc = ref_counts(codes, 9, _ref_mesh())
        wm, wc = np.unique(codes, return_counts=True)
        assert m.tolist() == rm.tolist() == wm.tolist()
        assert c.tolist() == rc.tolist() == wc.tolist()
        m3, c3 = sharded_mer_counts(codes, 9, _mesh(3))
        assert m3.tolist() == wm.tolist() and c3.tolist() == wc.tolist()

    def test_sharded_mer_counts_wide_raises(self):
        from genometools_torch.parallel.dist_tallymer import \
            sharded_mer_counts
        with pytest.raises(ValueError):
            sharded_mer_counts(np.zeros(4, np.int64), 19, _mesh())

    def test_distributed_maxpairs(self):
        from genometools_tpu.core.encseq import Encseq as RefEncseq
        from genometools_tpu.index.esa import build_esa as ref_build
        from genometools_tpu.parallel.dist_maxpairs import \
            distributed_maxpairs as ref_dmp

        from genometools_torch.index.esa import build_esa
        from genometools_torch.match.maxpairs import enumerate_maxpairs
        from genometools_torch.parallel.dist_maxpairs import \
            distributed_maxpairs
        s = _dna(11, 4000, "acgt")
        s = s + s[:600]                      # repeats for sure
        esa = build_esa(Encseq.from_string(s), device="cpu")
        got = distributed_maxpairs(esa, 12, devices=_mesh(4))
        want = enumerate_maxpairs(esa, 12)
        ref = ref_dmp(ref_build(RefEncseq.from_string(s), 0,
                                with_lcp=True), 12, devices=list(range(4)))
        for f in ("pos1", "pos2", "length"):
            assert getattr(got, f).tolist() == getattr(want, f).tolist() \
                == getattr(ref, f).tolist()
        assert got.count > 0


class TestBuildEsaOnMesh:
    @pytest.mark.parametrize("P", [2, 8])
    def test_build_esa_mesh_matches_reference(self, P, monkeypatch):
        from genometools_tpu.core.encseq import Encseq as RefEncseq
        from genometools_tpu.index.esa import build_esa as ref_build

        from genometools_torch.index.esa import build_esa
        s = _dna(21, 3000)
        monkeypatch.setenv("GT_TPU_DIST", str(P))
        want = ref_build(RefEncseq.from_string(s), 0, with_lcp=True,
                         dist=True)
        got = build_esa(Encseq.from_string(s), device="cpu", mesh=_mesh(P))
        single = build_esa(Encseq.from_string(s), device="cpu")
        assert got.suftab.tolist() == np.asarray(want.suftab).tolist() == \
            single.suftab.tolist()
        assert got.lcptab.tolist() == np.asarray(want.lcptab).tolist() == \
            single.lcptab.tolist()

    def test_dist_mesh(self):
        from genometools_torch.index.esa import dist_mesh
        assert [dist_mesh(n, "cpu").size for n in (None, 0, 1, 3, 8)] == \
            [1, 1, 1, 2, 8]


def test_cli_dist(tmp_path):
    """suffixerator -dist 4 writes the single-device files; seed_extend
    -dist 2 -parts 3 prints the reference CLI's bytes."""
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    (tmp_path / "g.fa").write_text("".join(
        f">s{i}\n{s}\n" for i, s in enumerate(_genome(5).split("|"))))
    for name, extra in (("one", []), ("four", ["-dist", "4"])):
        main(["suffixerator", "-db", str(tmp_path / "g.fa"), "-indexname",
              str(tmp_path / name), "-suf", "-lcp", "-tis", "-device",
              "cpu"] + extra)
    for ext in ("suf", "lcp", "llv", "prj"):
        assert (tmp_path / f"one.{ext}").read_bytes() == \
            (tmp_path / f"four.{ext}").read_bytes(), ext
    argv = ["seed_extend", "-ii", str(tmp_path / "one"), "-l", "30",
            "-dist", "2", "-parts", "3"]
    out = []
    for run, extra in ((ref_main, ["--cpu"]), (main, ["-device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run(argv + extra)
        out.append(buf.getvalue())
    assert out[1] == out[0] and out[0]


# ---------------------------------------------------------------------------
# repairs: the kernel loader's lock and the launch counters
# ---------------------------------------------------------------------------

def test_kernel_library_loads_once_across_threads(monkeypatch):
    """Threads that ask for the kernel or the native library while its
    first build runs wait for it: one build each."""
    from genometools_torch import _kernels
    from genometools_torch.core import native
    loads = []

    def slow_load(mod, **done):
        def load():
            loads.append(mod.__name__)
            threading.Event().wait(0.05)
            for name, value in done.items():
                setattr(mod, name, value)
        return load
    monkeypatch.setattr(_kernels, "_lib", None)
    monkeypatch.setattr(_kernels, "_load", slow_load(_kernels, _lib="K"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_load",
                        slow_load(native, _lib="N", _tried=True))
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        (_kernels.lib(), native.get_lib()))) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == [("K", "N")] * 8
    assert sorted(loads) == sorted([_kernels.__name__, native.__name__])


def test_launch_counters_are_thread_safe():
    from genometools_torch import _kernels
    g = {"launches": 0, "work": {"slot_gens": 0, "bytes": 0},
         "__name__": "genometools_torch.ops.fake"}
    _kernels.lane_launches.clear()

    def lane(tag):
        with _kernels.lane(tag, CPU):
            for _ in range(2000):
                _kernels.record_launch(g, 3, 5)
    threads = [threading.Thread(target=lane, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    _kernels.record_launch(g)              # outside a lane: no tag
    assert g["launches"] == 8001
    assert g["work"] == {"slot_gens": 24000, "bytes": 40000}
    assert _kernels.lane_launches == {(i, "fake"): 2000 for i in range(4)}


def test_dryrun_multichip():
    from genometools_torch.parallel.dryrun import dryrun_multichip
    line = dryrun_multichip(8, "cpu")
    assert line.startswith("dryrun_multichip OK on 8 shards")


@pytest.mark.cuda
def test_mesh_of_one_card_repeated():
    """On a card: eight shards of cuda:0 sort as one CPU shard does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from genometools_torch.parallel.dist_doubling_sharded import \
        sharded_suffix_array
    keys = _keys(_dna(8, 5000))
    dev = Mesh(["cuda:0"] * 8)
    assert sharded_suffix_array(keys, dev).tolist() == \
        sharded_suffix_array(keys, _mesh(1)).tolist()
