"""seed_extend's seed-pair join on the card (``match/seedjoin.py``),
run here on the CPU, against the native join and the numpy join, plane
for plane and in order: a self-comparison of one list, a strand against
a reverse-complement list, two encseqs, maxfreq, inseqseeds and
maxdist, empty lists, one sequence, many reads, a repeat-rich genome,
and a list not sorted by position. The routing of ``build_seed_pairs``
(host devices keep the host join) and its seedext.join span; the
vectorised ``_revcomp_codes`` against the per-sequence loop it
replaced, kept here as the oracle. On a card (``-m cuda``, with
``--noconftest``): the card join on read shapes, and seed_extend's lines
through it against the fused engine's."""

from pathlib import Path

import numpy as np
import pytest
import torch

from genometools_torch import trace
from genometools_torch.core.chardef import is_special
from genometools_torch.core.encseq import Encseq
from genometools_torch.core.native import seed_pair_join_native
from genometools_torch.match import seed_extend as tse
from genometools_torch.match.seedjoin import seed_pairs_device
from genometools_torch.utils.synthetic import planted_repeats

torch.set_num_threads(1)

AT1MB = Path(__file__).resolve().parent.parent / "portbench" / "data" / \
    "at1MB" / "idx"


def _shred(seqs, seed, coverage=2, minlength=300, maxlength=700):
    """Reads of minlength..maxlength bp cut from seqs, `coverage`
    passes, as gt shredder cuts them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(coverage):
        for seq in seqs:
            pos = 0
            while pos < len(seq):
                n = int(rng.integers(minlength, maxlength + 1))
                out.append(seq[pos:pos + n])
                pos += n
    return out


def _reads(seed=3, length=60_000):
    """A repeat-bearing genome shredded into 300-700 bp reads."""
    (genome,) = planted_repeats(seed, nseq=1, length=length, repeats=12,
                                replen=(500, 3_000), wildcard_runs=3)
    return Encseq.from_string("|".join(
        r.decode() for r in _shred([genome], seed)))


def _genome(seed=11, length=150_000):
    return Encseq.from_string("|".join(s.decode() for s in planted_repeats(
        seed, nseq=2, length=length, repeats=20, replen=(1_000, 6_000),
        wildcard_runs=4)))


def _joins(alist, blist, selfcomp, maxfreq=None, inseqseeds=True,
           mindist=1, maxdist=None):
    """The card join's planes on the CPU, held to the native and the
    numpy joins; returns (planes, candidates)."""
    got, cand = seed_pairs_device(alist, blist, selfcomp, maxfreq,
                                  inseqseeds, mindist, maxdist, "cpu")
    native = seed_pair_join_native(alist, blist, selfcomp, maxfreq,
                                   inseqseeds, mindist, maxdist)
    plain = tse._numpy_seed_pairs(alist, blist, selfcomp, maxfreq,
                                  inseqseeds, mindist, maxdist)
    assert all(p.dtype == np.int32 for p in got)
    for want in (native, plain):
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert cand >= got[0].size
    if not selfcomp:
        assert cand == got[0].size
    return got, cand


def _lists(enc, k, benc=None):
    benc = benc or enc
    return (tse.enumerate_kmers(enc, k), tse.enumerate_kmers(benc, k),
            tse.enumerate_kmers(benc, k, revcomp=True))


@pytest.mark.parametrize("what", ["reads", "genome"])
def test_self_comparison_both_strands(what):
    """F: one list against itself, mindist k; P: against the reverse
    complement list, mindist 0."""
    enc, k = (_reads(), 10) if what == "reads" else (_genome(), 11)
    al, _, rl = _lists(enc, k)
    f, fcand = _joins(al, al, True, mindist=k)
    p, pcand = _joins(al, rl, True, mindist=0)
    assert f[0].size and p[0].size
    # the F join starts each range after its own entry
    assert fcand < 2 * f[0].size
    assert (f[0] < f[1]).any() and (f[0] == f[1]).any()


@pytest.mark.parametrize("direction", ["F", "P"])
def test_two_encseqs(direction):
    enc, other = _reads(3), _reads(4)
    al, bl, rl = _lists(enc, 10, other)
    got, _ = _joins(al, bl if direction == "F" else rl, False,
                    mindist=10 if direction == "F" else 0)
    assert got[0].size


@pytest.mark.parametrize("maxfreq", [1, 2, 3, 6])
def test_maxfreq_drops_groups(maxfreq):
    al, _, rl = _lists(_reads(), 10)
    every, _ = _joins(al, al, True, mindist=10)
    got, _ = _joins(al, al, True, maxfreq=maxfreq, mindist=10)
    assert got[0].size < every[0].size
    _joins(al, rl, True, maxfreq=maxfreq, mindist=0)


@pytest.mark.parametrize("inseqseeds,maxdist", [(False, None), (False, 40),
                                                (True, 40), (True, 0)])
def test_inseqseeds_and_maxdist(inseqseeds, maxdist):
    enc = _genome(length=40_000)
    al, _, rl = _lists(enc, 11)
    for blist, mindist in ((al, 11), (rl, 0)):
        got, _ = _joins(al, blist, True, inseqseeds=inseqseeds,
                        mindist=mindist, maxdist=maxdist)
        same = got[0] == got[1]
        if not inseqseeds:
            assert not same.any()
        elif maxdist is not None:
            assert (got[2][same] - got[3][same] <= maxdist).all()


def test_empty_lists():
    al, _, _ = _lists(_reads(), 10)
    empty = tuple(a[:0] for a in al)
    for a, b in ((empty, empty), (al, empty), (empty, al)):
        got, cand = seed_pairs_device(a, b, True, None, True, 10, None, "cpu")
        assert cand == 0 and all(p.size == 0 for p in got)
    # lists with no common code
    other = al[0] != al[0][0]
    assert _joins(tuple(x[:1] for x in al), tuple(x[other] for x in al),
                  False)[1] == 0


def test_one_sequence():
    (genome,) = planted_repeats(5, nseq=1, length=30_000, repeats=6,
                                replen=(500, 2_000), wildcard_runs=1)
    enc = Encseq.from_string(genome.decode())
    al, _, rl = _lists(enc, 11)
    f, _ = _joins(al, al, True, mindist=11)
    _joins(al, rl, True, mindist=0)
    assert f[0].size and (f[0] == 0).all() and (f[1] == 0).all()


def test_unsorted_list_takes_whole_groups():
    """A list out of (seq, pos) order: every entry's range is its whole
    group, and the mask alone decides, as in the native join."""
    al, _, _ = _lists(_reads(), 10)
    order = np.random.default_rng(0).permutation(al[0].size)
    shuffled = tuple(a[order] for a in al)
    got, cand = _joins(shuffled, shuffled, True, mindist=10)
    want, wcand = _joins(al, al, True, mindist=10)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert cand > wcand


@pytest.mark.parametrize("device", [None, "cpu", torch.device("cpu")])
def test_host_devices_take_the_host_join(device, monkeypatch, spans):
    called = []
    monkeypatch.setattr(tse, "seed_pairs_device",
                        lambda *a, **kw: called.append(a))
    al, _, _ = _lists(_reads(), 10)
    pairs = tse.build_seed_pairs(al, al, True, None, mindist=10,
                                 device=device)
    want = seed_pair_join_native(al, al, True, None, True, 10, None)
    assert not called
    assert all(np.array_equal(p, w) for p, w in zip(pairs, want))
    (rec,) = [r for r in spans() if r.name == "seedext.join"]
    assert rec.attrs == {"route": "native", "candidates": None,
                         "pairs": want[0].size}


def test_cuda_device_takes_the_card_join(monkeypatch, spans):
    """A CUDA device's join goes to seed_pairs_device (run here on the
    CPU); where it declines (None), the native join answers."""
    al, _, rl = _lists(_reads(), 10)
    seen = []

    def on_cpu(*a):
        seen.append(a[-1])
        return seed_pairs_device(*a[:-1], "cpu")
    monkeypatch.setattr(tse, "seed_pairs_device", on_cpu)
    card = torch.device("cuda", 0)
    pairs = tse.build_seed_pairs(al, rl, True, None, mindist=0, device=card)
    want = seed_pair_join_native(al, rl, True, None, True, 0, None)
    assert seen == [card]
    assert all(np.array_equal(p, w) for p, w in zip(pairs, want))
    monkeypatch.setattr(tse, "seed_pairs_device", lambda *a: None)
    again = tse.build_seed_pairs(al, rl, True, None, mindist=0, device=card)
    assert all(np.array_equal(p, w) for p, w in zip(again, want))
    recs = [r for r in spans() if r.name == "seedext.join"]
    assert [r.attrs["route"] for r in recs] == ["card", "native"]
    assert recs[0].attrs["pairs"] == want[0].size <= \
        recs[0].attrs["candidates"]


def test_seed_extend_lines_through_the_card_join(monkeypatch):
    """seed_extend's lines with every strand's pairs from the card join
    (on the CPU) equal those through the native join."""
    enc = _reads(length=12_000)
    params = tse.SeedExtendParams(seedlength=10, minidentity=90,
                                  extension="xdrop",
                                  userdefinedleastlength=100)
    native = [m.line() for m in tse.seed_extend(enc, None, params,
                                                device="cpu")]
    join = tse.build_seed_pairs

    def card(*a, device=None, **kw):
        assert device is not None
        got = join(*a, device=torch.device("cuda"), **kw)
        assert got[0].dtype == np.int32
        return got
    monkeypatch.setattr(tse, "seed_pairs_device",
                        lambda *a: seed_pairs_device(*a[:-1], "cpu"))
    monkeypatch.setattr(tse, "build_seed_pairs", card)
    assert [m.line() for m in tse.seed_extend(enc, None, params,
                                              device="cpu")] == native
    assert native


def _revcomp_loop(enc):
    """The per-sequence loop ``_revcomp_codes`` replaced."""
    comp = enc.alphabet.complement_table()
    out = np.array(enc.codes, copy=True)
    for s in range(enc.num_sequences):
        lo = int(enc.seq_startpos(s))
        hi = int(enc.seq_endpos(s))
        seg = out[lo:hi + 1][::-1]
        out[lo:hi + 1] = np.where(is_special(seg), seg, comp[seg])
    return out


@pytest.mark.parametrize("text", [
    "acgtnnacggt",                      # one sequence, wildcards
    "a",                                # one symbol
    "n|a|c",                            # one-symbol first and last
    "acgtt|g|nacgn|tt",
    "ac||gt|",                          # empty sequences
    "reads",
])
def test_revcomp_codes_matches_the_loop(text):
    enc = _reads() if text == "reads" else Encseq.from_string(text)
    got = tse._revcomp_codes(enc)
    assert got.dtype == enc.codes.dtype
    assert np.array_equal(got, _revcomp_loop(enc))
    assert tse._revcomp_codes(enc) is got


# ---- on the card --------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _at1mb_reads():
    """The seedext.reads_xdrop cell's shape: at1MB shredded at 2x into
    300-700 bp reads."""
    from genometools_torch.core.esq import read_esq
    enc, _ = read_esq(str(AT1MB))
    seqs = [enc.codes[enc.seq_startpos(s):enc.seq_endpos(s) + 1]
            for s in range(enc.num_sequences)]
    text = np.frombuffer(b"acgt", np.uint8)
    reads = [np.where(r >= 4, ord("n"), text[np.minimum(r, 3)])
             .astype(np.uint8).tobytes().decode()
             for r in _shred(seqs, 1)]
    return Encseq.from_string("|".join(r for r in reads if r))


@pytest.mark.cuda
def test_card_join_on_read_shapes(cuda_device):
    enc = _at1mb_reads()
    al, _, rl = _lists(enc, 10)
    for blist, mindist in ((al, 10), (rl, 0)):
        got = seed_pairs_device(al, blist, True, None, True, mindist, None,
                                cuda_device)
        assert got is not None
        want = seed_pair_join_native(al, blist, True, None, True, mindist,
                                     None)
        assert all(np.array_equal(g, w) for g, w in zip(got[0], want))
        assert want[0].size > 1_000_000


@pytest.mark.cuda
def test_seed_extend_card_route_matches_fused(cuda_device):
    enc = _at1mb_reads()
    params = tse.SeedExtendParams(minidentity=90, extension="xdrop",
                                  userdefinedleastlength=100)
    trace.clear()
    trace.enable()
    try:
        wave = [m.line() for m in tse.seed_extend(enc, None, params,
                                                  device=cuda_device)]
        routes = [(r.attrs["route"], r.attrs["pairs"])
                  for r in trace.records() if r.name == "seedext.join"]
    finally:
        trace.enable(False)
        trace.clear()
    fused = [m.line() for m in tse.seed_extend(enc, None, params,
                                               engine="fused")]
    assert [r for r, _ in routes] == ["card", "card"]
    assert all(n > 0 for _, n in routes)
    assert wave == fused and wave
