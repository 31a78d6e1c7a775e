"""seed_extend's diagonal-band filter (``csrc/diagband.cpp``, one native
pass over the joined seed pairs) against the numpy filter it replaced,
kept here as the oracle: the selected seeds, their segment ordinals, the
kept segments' first pairs and ends, exactly, on random sorted pair sets
and on the edges (no pairs, one segment, one pair, the lowest band, no
filter, int64 positions past 2^31); and seed_extend's lines through the
native join's int32 pairs and the numpy join's int64 pairs."""

import numpy as np
import pytest
import torch

from genometools_torch.core.encseq import Encseq
from genometools_torch.core.native import diagband_select_native
from genometools_torch.match import seed_extend as tse

torch.set_num_threads(1)


def _diagband_filter(seg, apos, bpos, k, amaxlen, logw, mincov):
    """Per-seed diagonal-band coverage test of every segment at once
    (ref: diagband-struct.c). Seeds arrive sorted by (segment, bpos,
    apos), so a stable sort by (segment, band) makes each band an
    ascending-bpos run in which a seed covers min(k, bpos - previous
    bpos) new positions (k for the first). A seed passes when its band
    and the better of the two neighbouring bands cover mincov."""
    band = ((amaxlen + bpos - apos) >> logw) + 1    # neighbours stay >= 0
    key = seg * (int(band.max()) + 2) + band
    order = np.argsort(key, kind="stable")
    ks, bs = key[order], bpos[order]
    first = np.ones(ks.size, bool)
    first[1:] = ks[1:] != ks[:-1]
    contrib = np.full(ks.size, k, np.int64)
    contrib[1:] = np.where(first[1:], k, np.minimum(k, bs[1:] - bs[:-1]))
    starts = np.flatnonzero(first)
    bkeys, cover = ks[starts], np.add.reduceat(contrib, starts)

    def covered(q):
        i = np.searchsorted(bkeys, q).clip(max=bkeys.size - 1)
        return np.where(bkeys[i] == q, cover[i], 0)
    return covered(key) + np.maximum(covered(key - 1),
                                     covered(key + 1)) >= mincov


def _segments(pairs):
    """(pa_seq, pb_seq, pb_pos, pa_pos) as int64, each pair's segment
    (run of equal (aseq, bseq)) and the segments' first pairs."""
    pa_seq, pb_seq, pb_pos, pa_pos = (np.asarray(a, np.int64)
                                      for a in pairs)
    seg_break = np.ones(pa_seq.size, bool)
    seg_break[1:] = (pa_seq[1:] != pa_seq[:-1]) | (pb_seq[1:] != pb_seq[:-1])
    return (pa_seq, pb_seq, pb_pos, pa_pos), np.cumsum(seg_break) - 1, \
        np.flatnonzero(seg_break)


def _oracle(pairs, k, amaxlen, logw, mincov, use_filter=True):
    """(idx, sseg, kstart, g_end) as seed_extend's passes 1 and 2 made
    them before the native pass: the selected pair indices, each one's
    ordinal among the segments keeping a seed, those segments' first
    pairs and their ends in idx."""
    (_, _, pb_pos, pa_pos), seg, seg_starts = _segments(pairs)
    if seg.size == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    if use_filter:
        sel = _diagband_filter(seg, pa_pos, pb_pos, k, amaxlen, logw,
                               mincov)
    else:
        sel = np.ones(seg.size, bool)
    kept = np.flatnonzero(np.logical_or.reduceat(sel, seg_starts))
    idx = np.flatnonzero(sel)
    sseg = np.searchsorted(kept, seg[idx])
    g_end = np.searchsorted(sseg, np.arange(kept.size), "right")
    return idx, sseg, seg_starts[kept], g_end


def _median_coverage(pairs, k, amaxlen, logw):
    """The largest mincov that keeps at least half the seeds: some seed's
    coverage (its band plus the better neighbour) is exactly this."""
    (_, _, pb_pos, pa_pos), seg, _ = _segments(pairs)
    lo, hi = 0, 1 << 40
    while lo < hi:
        mid = (lo + hi + 1) // 2
        kept = _diagband_filter(seg, pa_pos, pb_pos, k, amaxlen, logw, mid)
        lo, hi = (mid, hi) if 2 * kept.sum() >= seg.size else (lo, mid - 1)
    return lo


def _native(pairs, k, amaxlen, logw, mincov, use_filter=True):
    return diagband_select_native(*pairs, k=k, amaxlen=amaxlen, logw=logw,
                                  mincov=mincov, use_filter=use_filter)


def _assert_same(got, want):
    names = ("idx", "sseg", "kstart", "g_end")
    for name, g, w in zip(names, got, want):
        assert g.dtype == np.int64, name
        assert np.array_equal(g, w), name


def _random_pairs(seed, k, amaxlen=700, n=4000, dtype=np.int32):
    """Seed pairs as the join gives them, sorted by (aseq, bseq, bpos,
    apos): a few sequences against a few, most seeds on a handful of
    diagonals a segment (so bands fill and neighbour one another), the
    rest anywhere, positions as k-mer ends."""
    rng = np.random.default_rng(seed)
    aseq = rng.integers(0, 4, n)
    bseq = rng.integers(0, 5, n)
    bmax = amaxlen + 300
    bpos = rng.integers(k - 1, bmax, n)
    diags = rng.integers(-amaxlen // 2, amaxlen // 2, (4, 5, 3))
    on_diag = bpos - diags[aseq, bseq, rng.integers(0, 3, n)] + \
        rng.integers(-3, 4, n)
    apos = np.where(rng.random(n) < 0.8, on_diag,
                    rng.integers(k - 1, amaxlen, n))
    apos = np.clip(apos, k - 1, amaxlen - 1)
    order = np.lexsort((apos, bpos, bseq, aseq))
    return tuple(a[order].astype(dtype) for a in (aseq, bseq, bpos, apos))


@pytest.mark.parametrize("mincov_step", [-1, 0, 1])
@pytest.mark.parametrize("logw", [0, 6, 10])
@pytest.mark.parametrize("k", [10, 11, 14])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_pairs_match_oracle(seed, k, logw, mincov_step):
    """Random sorted pair sets, mincov at, just below and just above a
    seed's coverage: the int32 and int64 entries both give the oracle's
    arrays exactly."""
    amaxlen = 700
    pairs = _random_pairs(seed, k, amaxlen)
    mincov = _median_coverage(pairs, k, amaxlen, logw) + mincov_step
    want = _oracle(pairs, k, amaxlen, logw, mincov)
    assert 0 < want[0].size < pairs[0].size
    _assert_same(_native(pairs, k, amaxlen, logw, mincov), want)
    wide = tuple(a.astype(np.int64) for a in pairs)
    _assert_same(_native(wide, k, amaxlen, logw, mincov), want)


def test_no_pairs():
    z = np.zeros(0, np.int32)
    got = _native((z, z, z, z), 11, 700, 6, 27)
    assert all(a.size == 0 for a in got)


@pytest.mark.parametrize("mincov_step", [-1, 0, 1])
def test_one_segment(mincov_step):
    aseq, bseq, bpos, apos = _random_pairs(4, 11, n=600)
    pairs = (np.zeros_like(aseq), np.ones_like(bseq), bpos, apos)
    mincov = _median_coverage(pairs, 11, 700, 6) + mincov_step
    want = _oracle(pairs, 11, 700, 6, mincov)
    got = _native(pairs, 11, 700, 6, mincov)
    _assert_same(got, want)
    assert got[2].tolist() == [0] and got[3].tolist() == [got[0].size]


@pytest.mark.parametrize("mincov", [10, 11, 12])
def test_one_pair(mincov):
    """A lone seed covers k: it passes at mincov <= k."""
    pairs = tuple(np.array([v], np.int32) for v in (2, 3, 500, 200))
    want = _oracle(pairs, 11, 700, 6, mincov)
    got = _native(pairs, 11, 700, 6, mincov)
    _assert_same(got, want)
    assert got[0].size == (mincov <= 11)


@pytest.mark.parametrize("logw", [0, 6])
def test_lowest_band(logw):
    """Every seed on the lowest diagonal, bpos - apos = -amaxlen: band 1,
    whose lower neighbour is the scratch's band 0."""
    amaxlen, k = 700, 11
    rng = np.random.default_rng(5)
    bpos = np.sort(rng.integers(0, 60, 40))
    seq = np.repeat(np.arange(4), 10)
    pairs = (seq, seq[::-1].copy(), bpos, bpos + amaxlen)
    order = np.lexsort((pairs[3], pairs[2], pairs[1], pairs[0]))
    pairs = tuple(a[order].astype(np.int32) for a in pairs)
    for mincov in (k, 2 * k, 3 * k):
        _assert_same(_native(pairs, k, amaxlen, logw, mincov),
                     _oracle(pairs, k, amaxlen, logw, mincov))


def test_below_the_lowest_band_raises():
    pairs = tuple(np.array([v], np.int32) for v in (0, 0, 10, 711))
    with pytest.raises(ValueError):
        _native(pairs, 11, 700, 6, 11)


def test_planes_of_other_lengths_raise():
    one, two = np.zeros(1, np.int32), np.zeros(2, np.int32)
    with pytest.raises(ValueError):
        _native((one, one, two, one), 11, 700, 6, 11)


def test_no_diagband_filter_keeps_every_seed():
    pairs = _random_pairs(6, 11)
    got = _native(pairs, 11, 700, 6, 10 ** 9, use_filter=False)
    _assert_same(got, _oracle(pairs, 11, 700, 6, 10 ** 9, use_filter=False))
    assert np.array_equal(got[0], np.arange(pairs[0].size))


@pytest.mark.parametrize("mincov_step", [-1, 0, 1])
def test_int64_positions_past_2_31(mincov_step):
    """The numpy join's int64 pairs: positions and amaxlen past 2^31 are
    taken whole, never truncated."""
    base = 2 ** 31 + 12345
    aseq, bseq, bpos, apos = _random_pairs(7, 14, dtype=np.int64)
    pairs = (aseq, bseq, bpos + base, apos + base)
    amaxlen = base + 700
    mincov = _median_coverage(pairs, 14, amaxlen, 6) + mincov_step
    want = _oracle(pairs, 14, amaxlen, 6, mincov)
    assert 0 < want[0].size
    _assert_same(_native(pairs, 14, amaxlen, 6, mincov), want)


def _planted(seed=8, nseq=5, n=700):
    rng = np.random.default_rng(seed)
    core = "".join(rng.choice(list("acgt"), 250))
    comp = str.maketrans("acgt", "tgca")
    parts = []
    for i in range(nseq):
        base = "".join(rng.choice(list("acgt"), n))
        rep = core if i % 2 else core[::-1].translate(comp)
        parts.append(base[:200] + rep + base[200:])
    return Encseq.from_string("|".join(parts))


@pytest.mark.parametrize("no_filter", [False, True])
def test_both_joins_give_the_same_lines(monkeypatch, no_filter):
    """seed_extend's lines are the same whether its pairs come from the
    native join (int32) or the numpy join with int64 planes (the route of
    32-mers and positions past 2^31)."""
    enc = _planted()
    params = tse.SeedExtendParams(seedlength=12, minidentity=85,
                                  extension="xdrop",
                                  userdefinedleastlength=20,
                                  no_diagband_filter=no_filter)
    seen = []
    join = tse.build_seed_pairs

    def spy(*a, **kw):
        pairs = join(*a, **kw)
        seen.append(pairs[0].dtype)
        return pairs
    monkeypatch.setattr(tse, "build_seed_pairs", spy)
    native = [m.line() for m in tse.seed_extend(enc, None, params,
                                                device="cpu")]
    assert native and set(seen) == {np.dtype(np.int32)}

    def numpy_join(alist, blist, selfcomp, maxfreq, inseqseeds=True,
                   mindist=1, maxdist=None):
        pairs = tuple(a.astype(np.int64) for a in tse._numpy_seed_pairs(
            alist, blist, selfcomp, maxfreq, inseqseeds, mindist, maxdist))
        seen.append(pairs[0].dtype)
        return pairs
    seen.clear()
    monkeypatch.setattr(tse, "build_seed_pairs", numpy_join)
    wide = [m.line() for m in tse.seed_extend(enc, None, params,
                                              device="cpu")]
    assert set(seen) == {np.dtype(np.int64)}
    assert wide == native
