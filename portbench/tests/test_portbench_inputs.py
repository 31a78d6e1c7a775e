"""The input generators: the same seed gives the same inputs, and each
meets its cell's parameters (at a shrunk size)."""

import numpy as np

from portbench import harness
from portbench.inputs import at1mb_reads, bacterial_pool, synthetic


def _ltr(seed, **over):
    p = dict(length=200_000, te_share=0.85, families=4,
             element_len=(2000, 5000), ltr_len=(100, 400),
             divergence=(0.0, 0.05), indel=0.005, tsd=5, wildcard_runs=5,
             wildcard_len=100)
    p.update(over)
    return synthetic.ltr_genome(np.random.default_rng(1),
                                harness.seeded(seed, "inputs"), **p)


def test_ltr_genome_deterministic_and_sized():
    a, b, c = _ltr(1), _ltr(1), _ltr(2)
    assert a == b and a != c
    assert len(a) == 200_000
    assert set(a) <= set(b"acgtn")
    assert 1 <= a.count(b"n" * 100) <= 5


def _repeated_share(text: bytes, k: int = 16) -> float:
    """The share of k-windows whose k-mer occurs more than once."""
    c = synthetic_codes(text)
    code = np.zeros(c.size - k + 1, np.int64)
    for j in range(k):
        code = code * 4 + c[j:j + code.size]
    _, inv, counts = np.unique(code, return_inverse=True,
                               return_counts=True)
    return float((counts[inv] > 1).mean())


def synthetic_codes(text: bytes) -> np.ndarray:
    lut = np.zeros(256, np.int64)
    lut[np.frombuffer(b"acgt", np.uint8)] = np.arange(4)
    return lut[np.frombuffer(text, np.uint8)]


def test_ltr_genome_is_repeat_rich():
    """Most of the sequence is diverged family copies: most of its
    16-mers occur more than once, against next to none in uniform
    random sequence of the same length."""
    assert _repeated_share(_ltr(3)) > 0.4
    assert _repeated_share(_ltr(3, te_share=0.0)) < 0.01


def test_random_codes_gc():
    c = synthetic.random_codes(np.random.default_rng(0), 400_000, 0.3)
    share = np.bincount(c, minlength=4) / c.size
    assert abs(share[1] + share[2] - 0.3) < 0.01
    assert abs(share[0] - share[3]) < 0.01


POOL = dict(genomes=6, shape_seed=1, median_bp=50_000, sigma=0.5,
            clip_bp=[20_000, 200_000], plasmids=[0, 3],
            plasmid_bp=[2000, 5000], gc=[0.3, 0.7], repeat_families=2,
            repeat_copies=[5, 15], repeat_bp=[500, 1000],
            repeat_divergence=[0.0, 0.01])


def test_bacterial_pool_shape_fixed_content_seeded(tmp_path):
    shape = bacterial_pool.shape(POOL)
    assert len(shape) == 6
    for chrom, plasmids, repeats, gc in shape:
        assert 20_000 <= chrom <= 200_000
        assert 0 <= len(plasmids) <= 3
        assert all(2000 <= p <= 5000 for p in plasmids)
        assert len(repeats) == 2
        assert all(500 <= n <= 1000 and 5 <= c <= 15 for n, c in repeats)
        assert 0.3 <= gc <= 0.7
    chroms = sorted(c for c, _, _, _ in shape)
    assert chroms[len(chroms) // 2 - 1] < 50_000 < chroms[len(chroms) // 2]
    runs = []
    for seed, sub in ((5, "a"), (5, "b"), (6, "c")):
        d = tmp_path / sub
        d.mkdir()
        out = bacterial_pool.make(POOL, harness.seeded(seed, "inputs"), d)
        runs.append((out, [p.read_bytes() for p in out["fastas"]]))
    (a, fa), (b, fb), (c, fc) = runs
    assert fa == fb and a["walks"] == b["walks"]
    assert fa != fc
    assert [len(x) for x in fa] == [len(x) for x in fc]   # same sizes
    assert a["walks"] == [a["warm"]] and sorted(a["warm"]) == list(range(6))


def test_bacterial_copies_fixed_and_whole():
    """Every run holds the same repeat copies, each whole: the run's
    seed moves them and the sequence around them only."""
    reps, div = [(300, 6), (500, 5)], (0.0, 0.01)
    want = [synthetic.ACGT[c].tobytes() for c in synthetic.repeat_copies(
        np.random.default_rng(3), 0.5, reps, div)]
    chroms = [synthetic.bacterial_genome(
        np.random.default_rng(3), np.random.default_rng(seed), 40_000,
        0.5, [], reps, div)[0] for seed in (1, 2)]
    assert chroms[0] != chroms[1]
    for chrom in chroms:
        assert all(c in chrom for c in want)


def test_read_esq_equals_the_ports_reader():
    from genometools_torch.core.esq import read_esq
    enc, _ = read_esq(str(at1mb_reads.DATA / "idx"))
    seqs = at1mb_reads.read_esq(at1mb_reads.DATA / "idx")
    lut = np.frombuffer(b"acgtn", np.uint8)
    assert len(seqs) == enc.num_sequences == 1952
    for s in (0, 1, 977, 1951):
        lo, hi = int(enc.seq_startpos(s)), int(enc.seq_endpos(s))
        c = enc.codes[lo:hi + 1]
        assert lut[np.where(c < 4, c, 4)].tobytes() == seqs[s]


def test_shredder_equals_the_ports_and_covers(tmp_path):
    from genometools_torch.core.seqio import SeqSet
    from genometools_torch.utils.seqtools import shredder
    seqs = at1mb_reads.read_esq(at1mb_reads.DATA / "idx")[:200]
    ss = SeqSet()
    ss.seqs = [np.frombuffer(s, np.uint8) for s in seqs]
    ss.descs = [""] * len(seqs)
    want = shredder(ss, 300, 700, coverage=2, seed=9)
    got = at1mb_reads.shredder(seqs, 300, 700, 0, 2,
                               np.random.default_rng(9))
    assert [bytes(w) for w in want.seqs] == got
    assert sum(map(len, got)) == 2 * sum(map(len, seqs))
    assert max(map(len, got)) <= 700


def _reads(fasta: bytes) -> list[bytes]:
    return sorted(b"".join(r.split(b"\n")[1:]) for r in fasta.split(b">")[1:])


def test_at1mb_reads_deterministic(tmp_path, small_cell):
    p = dict(shred_seed=1, coverage=2, minlength=300, maxlength=700,
             overlap=0, orders=3)
    outs = []
    for sub, seed in (("a", 3), ("b", 3), ("c", 4)):
        d = tmp_path / sub
        d.mkdir()
        o = at1mb_reads.make(p, harness.seeded(seed, "inputs"), d)
        assert o["walks"] == [[0], [1]] and o["warm"] == [2]
        outs.append((o["read_bp"], [f.read_bytes() for f in o["fastas"]]))
    assert outs[0] == outs[1] and outs[0][1] != outs[2][1]
    assert outs[0][0] == outs[2][0]          # 2x the shredded sequences
    # the same reads in every file of every seed, each in another order
    files = outs[0][1] + outs[2][1]
    assert len(set(files)) == len(files)
    assert all(_reads(f) == _reads(files[0]) for f in files)


def test_ltr_chromosome_rotations(tmp_path):
    from portbench.inputs import ltr_chromosome
    p = dict(shape_seed=1, length=60_000, te_share=0.85, families=3,
             element_len=[2000, 5000], ltr_len=[100, 400],
             divergence=[0.0, 0.05], indel=0.005, tsd=5, wildcard_runs=2,
             wildcard_len=100, rotations=3)
    o = ltr_chromosome.make(p, harness.seeded(5, "inputs"), tmp_path)
    assert o["walks"] == [[0], [1]] and o["warm"] == [2]
    seqs = [b"".join(f.read_bytes().split(b"\n")[1:]) for f in o["fastas"]]
    assert len(set(seqs)) == 3 and all(len(x) == 60_000 for x in seqs)
    assert all(x in seqs[0] + seqs[0] for x in seqs)    # rotations
