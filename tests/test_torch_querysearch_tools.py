"""genometools_torch genomediff, shulengthdist, uniquesub and matstat
against the reference package on the CPU: each tool's lines through
both CLIs on the tests/golden_esa inputs, the shulen sums of the
library on planted-repeat genomes, and the matching statistics and
unique substrings row for row. Every comparison is exact."""

import contextlib
import io
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from genometools_torch.core.encseq import Encseq
from genometools_torch.index.esa import load_esa
from genometools_torch.match import genomediff as pg
from genometools_torch.match import querysearch as pq

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parents[1] / "tests" / "golden_esa"
DBS = ["Random159.fna", "Random160.fna", "Atinsert.fna", "small_poly.fas",
       "trna_glutamine.fna"]


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    """The golden inputs as FASTA files, by name."""
    d = tmp_path_factory.mktemp("fa")
    lut = np.frombuffer(b"acgtn", np.uint8)
    for name in DBS:
        enc = Encseq.load(str(GOLDEN / name / "idx"))
        with open(d / name, "wb") as f:
            for s in range(enc.num_sequences):
                lo, hi = int(enc.seq_startpos(s)), int(enc.seq_endpos(s))
                c = enc.codes[lo:hi + 1]
                f.write(b">" + enc.descs[s].encode("latin-1") + b"\n"
                        + lut[np.where(c < 4, c, 4)].tobytes() + b"\n")
    return d


def _idx(name):
    return str(GOLDEN / name / "idx")


def _narrow(s, lo, hi, depth, sym):
    """Oracle: the sub-interval of suftab slots [lo, hi) whose depth char
    is sym, by two searchsorted calls over the slice."""
    idx = s.sa[lo:hi] + depth
    chars = np.where(idx < s.n, s.codes[np.minimum(idx, s.n - 1)],
                     np.uint8(255))
    return (lo + int(np.searchsorted(chars, sym, "left")),
            lo + int(np.searchsorted(chars, sym, "right")))


def _interval(s, pattern):
    """Oracle: the suftab interval of suffixes with `pattern` as prefix
    (ref: gt_mmsearch), one character at a time."""
    lo, hi = 0, s.sa.size
    for depth, sym in enumerate(pattern):
        if sym >= 250 or lo >= hi:
            return lo, lo
        lo, hi = _narrow(s, lo, hi, depth, int(sym))
    return lo, hi


def _longest_prefix_match(s, query):
    """Oracle: length of the longest prefix of `query` in the index."""
    lo, hi, length = 0, s.sa.size, 0
    while length < len(query) and query[length] < 250:
        l2, h2 = _narrow(s, lo, hi, length, int(query[length]))
        if l2 >= h2:
            break
        lo, hi, length = l2, h2, length + 1
    return length


CASES = [
    ["genomediff", "Random159.fna", "Random160.fna"],
    ["genomediff", "trna_glutamine.fna", "small_poly.fas", "Random159.fna"],
    ["shulengthdist", "-ii", _idx("Random159.fna")],
    ["shulengthdist", "-ii", _idx("small_poly.fas")],
    ["shulengthdist", "-ii", _idx("Random160.fna"), "-q",
     "trna_glutamine.fna", "Random159.fna"],
    ["uniquesub", "-esa", _idx("Atinsert.fna"), "-query",
     "trna_glutamine.fna"],
    ["uniquesub", "-esa", _idx("Random159.fna"), "-query", "Random160.fna",
     "-min", "3", "-max", "8", "-output-sequence"],
    ["uniquesub", "-esa", _idx("small_poly.fas"), "-query",
     "Random159.fna", "small_poly.fas"],
    ["matstat", "-esa", _idx("Atinsert.fna"), "-query",
     "trna_glutamine.fna"],
    ["matstat", "-esa", _idx("small_poly.fas"), "-query", "Random160.fna"],
]


@pytest.mark.parametrize("argv", CASES, ids=lambda a: "-".join(
    Path(x).parent.name or x for x in a[:3]))
def test_cli_matches_reference(fastas, argv):
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    cwd = os.getcwd()
    os.chdir(fastas)
    try:
        outs = []
        for m, flag in ((ref_main, ["--cpu"]), (main, ["-device", "cpu"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                m(argv + flag)
            outs.append(buf.getvalue())
    finally:
        os.chdir(cwd)
    assert outs[1] == outs[0] and outs[0]


@pytest.fixture(scope="module")
def planted():
    """Two 3 kbp sequences with planted repeats (copies within and
    across them, some reverse-complemented) and wildcard runs."""
    from genometools_torch.utils.synthetic import planted_repeats
    from genometools_torch.core.alphabet import dna_alphabet
    seqs = planted_repeats(seed=7, length=3000, repeats=6,
                           replen=(200, 800), wildcard_runs=2)
    alpha = dna_alphabet()
    return [alpha.encode(np.frombuffer(s, np.uint8)) for s in seqs]


def test_genomediff_on_planted_repeats(planted):
    """genomediff's sums and Kr values, shulen_sum and average_shulen on
    two planted-repeat genomes equal the reference's."""
    from genometools_tpu.core.encseq import Encseq as RefEncseq
    from genometools_tpu.match import genomediff as rg

    from genometools_torch.core.alphabet import dna_alphabet
    from genometools_tpu.core.alphabet import dna_alphabet as ref_dna

    def mk(cls, alpha, c):
        return cls(c.copy(), np.zeros(0, np.int64), ["g"], alpha)
    port = [mk(Encseq, dna_alphabet(), c) for c in planted]
    ref = [mk(RefEncseq, ref_dna(), c) for c in planted]
    sums, kr = pg.genomediff(port, device="cpu")
    rsums, rkr = rg.genomediff(ref)
    assert np.array_equal(sums, rsums) and np.array_equal(kr, rkr)
    assert sums[0, 1] > 0
    assert pg.shulen_sum(port[0], planted[1], device="cpu") == \
        rg.shulen_sum(ref[0], planted[1])
    assert pg.average_shulen(port[1], planted[0], device="cpu") == \
        rg.average_shulen(ref[1], planted[0])


def test_shulen_sums_against_searcher(planted):
    """Each sum of the one-ESA scan equals the per-position search over
    the subject's own index (the scalar oracle _longest_prefix_match),
    with the subject's ESA built by the host SA-IS and Kasai engines."""
    from genometools_torch.core.alphabet import dna_alphabet
    from genometools_torch.index.esa import EnhancedSuffixArray, host_sa_lcp
    alpha = dna_alphabet()
    sums = pg.shulen_sums(planted, [0, 1], alpha, device="cpu")
    for i, j in ((0, 1), (1, 0)):
        enc = Encseq(planted[j].copy(), np.zeros(0, np.int64), ["s"], alpha)
        sa, lcp = host_sa_lcp(enc.suffix_keys())
        s = pq.SuffixArraySearcher(EnhancedSuffixArray(enc, 0, sa, lcp))
        q = planted[i]
        want = sum(_longest_prefix_match(s, q[p:]) + 1
                   for p in range(q.size) if q[p] < 4)
        assert sums[i, j] == want


PAIRS = [
    ("Atinsert.fna", "trna_glutamine.fna"),
    ("Atinsert.fna", "Random159.fna"),
    ("Random159.fna", "Random160.fna"),
    ("small_poly.fas", "Duplicate.fna")]


@pytest.mark.parametrize("db,query", PAIRS)
def test_matstat_and_uniquesub_rows(db, query):
    """matching_statistics against the scalar oracle
    _longest_prefix_match per position, and minimum_unique_substrings
    against the reference's definition (interval of each prefix length
    from depth 0), on the whole query."""
    esa = load_esa(_idx(db))
    q = Encseq.load(_idx(query))
    qc = q.codes_view(0)
    s = pq.SuffixArraySearcher(esa)
    ms = pq.matching_statistics(esa, q)
    want = np.asarray([0 if qc[p] >= 254 else
                       _longest_prefix_match(s, qc[p:])
                       for p in range(qc.size)])
    assert np.array_equal(ms, want) and ms.max() > 0
    got = pq.minimum_unique_substrings(esa, q, 2, 12)
    ref = []
    for p in range(qc.size):
        if qc[p] >= 254:
            continue
        for length in range(1, min(12, qc.size - p) + 1):
            if qc[p + length - 1] >= 254:
                break
            lo, hi = _interval(s, qc[p:p + length])
            if hi - lo <= 1:
                if hi - lo == 1 and length >= 2:
                    ref.append((p, length))
                break
    assert got == ref


@pytest.mark.parametrize("db,query", PAIRS)
def test_query_substring_matches_rows(db, query):
    """query_substring_matches (repfind -q's rows, taken from the
    matching statistics' intervals) equal the reference's per-position
    search at two minimum lengths."""
    from genometools_tpu.core.encseq import Encseq as RefEncseq
    from genometools_tpu.index.esa import load_esa as ref_load
    from genometools_tpu.match.querysearch import \
        query_substring_matches as ref_qsm
    esa, ref = load_esa(_idx(db)), ref_load(_idx(db))
    q, rq = Encseq.load(_idx(query)), RefEncseq.load(_idx(query))
    counts = []
    for minlength in (1, 8):
        want = ref_qsm(ref, rq, minlength)
        assert pq.query_substring_matches(esa, q, minlength) == want
        counts.append(len(want))
    assert counts[0] > counts[1]
