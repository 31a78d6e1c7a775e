"""The plain references against brute force at tiny sizes, and against
the port (a second witness) on a small read set."""

import itertools

import numpy as np
import pytest

from portbench.reference import fasta
from portbench.reference import seed_extend as R
from portbench.reference.suffix_array import sa_lcp

CODES = np.frombuffer(b"acgtn", np.uint8)


def _records(rng, lens, alphabet=b"acgtn", p=None):
    return [fasta._LUT[rng.choice(np.frombuffer(alphabet, np.uint8), n,
                                  p=p)] for n in lens]


def _brute_sa_lcp(keys):
    n = keys.size
    suf = sorted(range(n), key=lambda i: keys[i:].tolist())
    lcp = [0]
    for a, b in zip(suf, suf[1:]):
        lcp.append(next(i for i in itertools.count()
                        if a + i >= n or b + i >= n or keys[a + i] !=
                        keys[b + i]))
    return np.asarray(suf), np.asarray(lcp)


@pytest.mark.parametrize("seed", range(6))
def test_suffix_array_matches_brute_force(seed):
    rng = np.random.default_rng(seed)
    recs = _records(rng, rng.integers(1, 60, rng.integers(1, 4)),
                    b"acgtn" if seed % 2 else b"ac",
                    p=[0.24, 0.24, 0.24, 0.24, 0.04] if seed % 2 else None)
    keys = fasta.suffix_keys(recs)
    sa, lcp = sa_lcp(keys)
    bsa, blcp = _brute_sa_lcp(keys)
    assert (sa == bsa).all() and (lcp == blcp).all()


def test_suffix_array_matches_the_port(tmp_path):
    from genometools_torch.core.encseq import FWD, Encseq
    from genometools_torch.index.esa import build_esa
    rng = np.random.default_rng(7)
    body = rng.choice(np.frombuffer(b"acgt", np.uint8), 6000)
    body[3000:4000] = body[100:1100]              # a 1 kbp repeat
    body[500:520] = ord("n")
    path = tmp_path / "g.fna"
    path.write_bytes(b">a\n" + body[:4500].tobytes() + b"\n>b\n" +
                     body[4500:].tobytes() + b"\n")
    esa = build_esa(Encseq.from_files([str(path)]), FWD, with_lcp=True,
                    device="cpu")
    sa, lcp = sa_lcp(fasta.suffix_keys(fasta.read_records(path)))
    assert (sa == esa.suftab).all() and (lcp == esa.lcptab).all()
    # the control sorts by 32 keys only: it must differ here
    csa, clcp = sa_lcp(fasta.suffix_keys(fasta.read_records(path)),
                       depth_log2=5)
    assert (clcp != lcp).any()


def _brute_xdrop_best(u, v):
    """Best score of any alignment of a prefix of u with a prefix of v
    (match 2, mismatch -1, indel -2): an upper bound of X-drop's, and
    its value when nothing is dropped."""
    m, n = len(u), len(v)
    S = np.full((m + 1, n + 1), -10 ** 9)
    S[0, 0] = 0
    for i in range(m + 1):
        for j in range(n + 1):
            if i and j:
                s = 2 if u[i - 1] == v[j - 1] and u[i - 1] < 0xFE else -1
                S[i, j] = max(S[i, j], S[i - 1, j - 1] + s)
            if i:
                S[i, j] = max(S[i, j], S[i - 1, j] - 2)
            if j:
                S[i, j] = max(S[i, j], S[i, j - 1] - 2)
    return int(S.max())


@pytest.mark.parametrize("seed", range(30))
def test_xdrop_against_brute_force(seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, rng.integers(1, 40)).astype(np.uint8)
    other = base.copy()
    for _ in range(rng.integers(0, 6)):
        p = int(rng.integers(0, other.size))
        other[p] = (other[p] + 1) % 4
    if seed % 3 == 0:
        other = np.concatenate([other[:5], other[7:]])
    u, v = base.tobytes(), other.tobytes()
    best = _brute_xdrop_best(u, v)
    i, j, s = R.xdrop(u, v, 10 ** 6)
    assert s == best
    for below in (1, 5):
        i, j, s = R.xdrop(u, v, below)
        assert s <= best and 0 <= i <= len(u) and 0 <= j <= len(v)
        assert _brute_xdrop_best(u[:i], v[:j]) >= s


def test_seed_pairs_and_band_filter_match_brute_force():
    rng = np.random.default_rng(3)
    reads = _records(rng, [40, 35, 50], b"ac")
    k = 4
    got = {}
    for strand, blist, mindist in (("F", R.kmers(reads, k, False), k),
                                   ("P", R.kmers(reads, k, True), 0)):
        got[strand] = list(zip(*(x.tolist() for x in
                                 R.seed_pairs(R.kmers(reads, k, False),
                                              blist, mindist))))
        want = []
        for a, ra in enumerate(reads):
            for b, rb in enumerate(reads):
                rb = R.strand_codes(rb, strand == "P")
                for i in range(ra.size - k + 1):
                    for j in range(rb.size - k + 1):
                        if (ra[i:i + k] == rb[j:j + k]).all() and \
                                (a < b or (a == b and i + mindist <= j)):
                            want.append((a, b, i + k - 1, j + k - 1))
        want.sort(key=lambda t: (t[0], t[1], t[3], t[2]))
        assert got[strand] == want
    aseq, bseq, apos, bpos = (np.asarray(x) for x in zip(*got["F"]))
    sel = R.diagband_select(aseq, bseq, apos, bpos, k, 50, 2, 10)
    for t, (a, b, ap, bp) in enumerate(zip(aseq, bseq, apos, bpos)):
        band = lambda x, y: (50 + y - x) >> 2
        def cover(bd):
            ps = sorted(bpos[s] for s in range(aseq.size)
                        if aseq[s] == a and bseq[s] == b and
                        band(apos[s], bpos[s]) == bd)
            return sum(k if i == 0 else min(k, ps[i] - ps[i - 1])
                       for i in range(len(ps)))
        bd = band(ap, bp)
        assert sel[t] == (cover(bd) + max(cover(bd - 1),
                                          cover(bd + 1)) >= 10)


def test_seed_extend_reference_matches_the_port(tmp_path):
    """Every segment of a small at1MB read set: the reference's lines
    equal the port's (its fused host engine: the same lines as the
    card's path, fast on the CPU)."""
    from genometools_torch.core.encseq import Encseq
    from genometools_torch.match.seed_extend import (SeedExtendParams,
                                                     seed_extend)

    from portbench.inputs import at1mb_reads
    from portbench.inputs.synthetic import write_fasta
    seqs = at1mb_reads.read_esq(at1mb_reads.DATA / "idx")[:400]
    reads = at1mb_reads.shredder(seqs, 300, 700, 0, 2,
                                 np.random.default_rng(5))
    path = tmp_path / "reads.fna"
    write_fasta(path, [(f"r{i}", r) for i, r in enumerate(reads)])
    params = dict(minidentity=90, sensitivity=97,
                  userdefinedleastlength=100, extension="xdrop")
    prog = [m.line() for m in seed_extend(
        Encseq.from_files([str(path)]), None, SeedExtendParams(**params),
        engine="fused")]
    plan = R.Plan(fasta.read_records(path), params)
    ref = [line for s in plan.segments for line in plan.lines(s)]
    assert len(prog) > 100
    assert ref == prog


def test_xdrop_table_is_gts():
    from genometools_torch.ops.xdrop import optimal_xdrop_belowscore
    for sens in range(88, 101):
        for err in range(0, 35):
            assert R.xdrop_belowscore(err, sens) == \
                optimal_xdrop_belowscore(err, sens)
