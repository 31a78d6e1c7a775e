"""The packed index in genometools_torch against the reference package
and gt's own outputs: FMIndex count and locate, fmindex_from_codes,
the torch FMDeviceRank (on the CPU) against the host backward search,
the .bdx reader on the four gt-written goldens (tests/golden_bdx)
against the BWT of the port's build_esa over gt's golden indexes, the
.bdx writer's bytes, tagerator -esa and -pck against gt's eight golden
outputs (tests/golden_tagerator, per-tag sorted rows, as
test_tagerator_golden.py compares them) with the batched engines equal
to the per-tag DFS copies, prebwt's .pbt, mergeesa's files and sain's
suffix array. Exact comparisons throughout.
"""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from genometools_torch.core.encseq import Encseq as TEncseq
from genometools_torch.index import bdx as tbdx
from genometools_torch.index import fmindex as tfm
from genometools_torch.index.esa import build_esa as tbuild

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden_esa"
GBDX = ROOT / "tests" / "golden_bdx"
GTAG = ROOT / "tests" / "golden_tagerator"
ATINSERT = GOLDEN / "Atinsert.fna" / "idx"


def _text(seed, n=800, wild=0.04):
    rng = np.random.default_rng(seed)
    s = "".join(rng.choice(list("acgtn"), n, p=[(1 - wild) / 4] * 4 +
                           [wild]))
    return s[:300] + "|" + s[300:]


def test_fmindex_count_locate_match_reference():
    from genometools_tpu.core.encseq import Encseq as REncseq
    from genometools_tpu.index.fmindex import build_fmindex as rbuild
    text = _text(0)
    t, r = TEncseq.from_string(text), REncseq.from_string(text)
    fm = tfm.build_fmindex(t, device="cpu")
    ref = rbuild(r)
    for f in ("bwt", "counts_less", "occ_checkpoints", "sa_samples"):
        assert np.array_equal(getattr(fm, f), getattr(ref, f)), f
    esa = tbuild(t, with_lcp=False, device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(60):
        p = int(rng.integers(0, t.total_length - 6))
        pat = t.codes[p:p + int(rng.integers(1, 7))]
        assert fm.backward_search(pat) == ref.backward_search(pat)
        assert fm.count(pat) == ref.count(pat)
        assert fm.locate(pat, esa_sa=esa.suftab).tolist() == \
            ref.locate(pat, esa_sa=esa.suftab).tolist()


def test_fmindex_from_codes_matches_reference(tmp_path):
    from genometools_tpu.index.fmindex import fmindex_from_codes as rfc
    t = TEncseq.from_string(_text(2, 1500))
    fm = tfm.fmindex_from_codes(t.codes, device="cpu")
    ref = rfc(t.codes)
    for f in ("bwt", "counts_less", "occ_checkpoints", "sa_samples",
              "sa_full"):
        assert np.array_equal(getattr(fm, f), getattr(ref, f)), f
    fm.save(str(tmp_path / "x"))
    back = tfm.FMIndex.load(str(tmp_path / "x"))
    assert np.array_equal(back.bwt, fm.bwt)
    assert back.block_size == fm.block_size


@pytest.mark.parametrize("n", [3000, 127 * 128 - 1])
def test_device_rank_matches_host(n):
    """FMDeviceRank's torch ops on the CPU: occ_batch against the host
    occ at every kind of position (n + 1 = 127 blocks exactly in the
    second case, the last position at a block boundary), and the
    batched backward search of left-padded patterns against the host
    backward search."""
    rng = np.random.default_rng(n)
    t = TEncseq.from_string("".join(rng.choice(list("acgt"), n)))
    fm = tfm.fmindex_from_codes(t.codes, device="cpu")
    dev = tfm.FMDeviceRank(fm, device="cpu")
    cs = rng.integers(0, 4, 400)
    ps = np.concatenate([rng.integers(0, fm.bwt.size + 1, 396),
                         [0, 128, fm.bwt.size - 1, fm.bwt.size]])
    got = dev.occ_batch(torch.from_numpy(cs), torch.from_numpy(ps))
    want = [int(fm.counts_less[c + 1] - fm.counts_less[c])
            if p == fm.bwt.size else fm.occ(int(c), int(p))
            for c, p in zip(cs, ps)]
    assert got.tolist() == want
    B, m = 200, 14
    pats = np.full((B, m), 255, np.uint8)
    for i in range(B):
        p = int(rng.integers(0, t.total_length - m))
        L = int(rng.integers(1, m + 1))
        pats[i, m - L:] = t.codes[p:p + L]
        if i % 7 == 0:
            pats[i, m - L:] = rng.integers(0, 4, L)
    lo, hi = dev.backward_search_batch(pats)
    sa = fm.sa_full
    for i in range(B):
        pat = pats[i][pats[i] != 255]
        assert (lo[i], hi[i]) == fm.backward_search(pat)
        # the suffixes in the interval start with the pattern
        for r in range(lo[i], hi[i]):
            assert np.array_equal(t.codes[sa[r]:sa[r] + pat.size], pat)


# (golden, index of the same input in tests/golden_esa, readmode)
BDX = [("default.bdx", "Atinsert.fna", 0), ("bsize4.bdx", "Duplicate.fna", 0),
       ("rev.bdx", "Random.fna", 1), ("ttt.bdx", "TTT-small.fna", 0)]


@pytest.mark.parametrize("case", BDX)
def test_decode_bwt_of_gt_goldens(case):
    gold, db, readmode = case
    enc = TEncseq.load(str(GOLDEN / db / "idx"))
    ours = tbuild(enc, readmode=readmode, with_lcp=False,
                  device="cpu").bwt().astype(np.int16)
    got = tbdx.decode_bwt(str(GBDX / gold))
    assert got.size == ours.size and (got == ours).all()


def test_write_bdx_matches_reference(tmp_path):
    from genometools_tpu.index.bdx import write_bdx
    enc = TEncseq.load(str(GOLDEN / "Duplicate.fna" / "idx"))
    bwt = tbuild(enc, with_lcp=False, device="cpu").bwt().astype(np.int16)
    counts = [int((enc.codes == c).sum()) for c in range(4)]
    tbdx.write_bdx(str(tmp_path / "t.bdx"), bwt, counts)
    write_bdx(str(tmp_path / "r.bdx"), bwt, counts)
    assert (tmp_path / "t.bdx").read_bytes() == \
        (tmp_path / "r.bdx").read_bytes()
    assert (tbdx.decode_bwt(str(tmp_path / "t.bdx")) == bwt).all()


def _rows(text):
    per_tag, cur = {}, None
    for line in text.splitlines():
        if line.startswith("#\t"):
            cur = line.split("\t")[1]
            per_tag.setdefault(cur, [])
        elif not line.startswith("#") and line.strip():
            per_tag[cur].append(tuple(line.split()))
    return {k: sorted(v) for k, v in per_tag.items()}


def _cli(argv) -> str:
    from genometools_torch.cli import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv + ["-device", "cpu"]) == 0
    return buf.getvalue()


# seven of the eight argument sets of gt's golden outputs; the eighth,
# -maxocc 5, switches gt to prefix matches ("computing prefix matches
# ... at most 5 occurrences", golden_e_1_maxocc_5.txt), which the
# reference package does not implement: it keeps the first rows of each
# search, and the port copies it (test below; ROADMAP, Queue 3)
TAGERATOR = [(["-e", "0"], "golden_e_0.txt"),
             (["-e", "1"], "golden_e_1.txt"),
             (["-e", "2"], "golden_e_2.txt"),
             (["-e", "2", "-best"], "golden_e_2_best.txt"),
             (["-e", "1", "-nop"], "golden_e_1_nop.txt"),
             (["-e", "1", "-nod"], "golden_e_1_nod.txt"),
             (["-e", "1", "-output", "tagnum", "tagseq", "dblength",
               "dbstartpos", "strand", "edist"],
              "golden_e_1_output_tagnum_tagseq_dblength_dbstartpos_"
              "strand_edist.txt")]


@pytest.mark.parametrize("route", ["-esa", "-pck"])
@pytest.mark.parametrize("case", TAGERATOR)
def test_tagerator_matches_gt_goldens(case, route):
    args, golden = case
    out = _cli(["tagerator"] + args + ["-q", str(GTAG / "tags.fna"), route,
                                       str(ATINSERT)])
    want = (GTAG / golden).read_text()
    assert _rows(out) == _rows(want)


@pytest.mark.parametrize("route", ["-esa", "-pck"])
def test_tagerator_maxocc_matches_reference_package(route):
    from genometools_tpu.cli import main as ref_main
    argv = ["tagerator", "-e", "1", "-maxocc", "5", "-q",
            str(GTAG / "tags.fna"), route, str(ATINSERT)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_main(argv + ["--cpu"])
    assert _cli(argv) == buf.getvalue()


def test_tagerator_batch_equals_dfs_copies():
    """The batched engines return the per-tag DFS copies' rows in their
    order, on the ESA and on the packed index, on gt's tags and on
    24-mers with edits."""
    from genometools_torch.core.seqio import read_seqfile
    from genometools_torch.index.esa import load_esa
    from genometools_torch.match import querysearch as tq
    enc = TEncseq.load(str(ATINSERT))
    esa = load_esa(str(ATINSERT), encseq=enc)
    fm = tfm.fmindex_from_codes(enc.codes[::-1].copy(), device="cpu")
    tags = [enc.alphabet.encode(s) for s in
            read_seqfile(str(GTAG / "tags.fna")).seqs]
    rng = np.random.default_rng(8)
    for _ in range(12):
        p = int(rng.integers(0, enc.total_length - 24))
        tag = enc.codes[p:p + 24].copy()
        if (tag < 4).all():
            tag[rng.integers(0, 24, 2)] = rng.integers(0, 4, 2)
            tags.append(tag)
    for e in (0, 1, 2):
        a = tq.esa_tagerator_batch(esa, tags, e)
        b = tfm.pck_tagerator_batch(fm, tags, e, enc.total_length,
                                    device="cpu")
        for i, tag in enumerate(tags):
            assert a[i] == tq.tagerator_search(esa, tag, e), (e, i)
            assert b[i] == tfm.pck_tagerator_search(fm, tag, e,
                                                    enc.total_length)
            assert sorted(a[i]) == sorted(b[i])


def _long_tags(enc, seed, n=10):
    """n tags of 32-40 bp of the text, each with 0-2 random edits, and
    two of random symbols: paths deeper than 31 - e symbols."""
    rng = np.random.default_rng(seed)
    tags = []
    while len(tags) < n:
        L = int(rng.integers(32, 41))
        p = int(rng.integers(0, enc.total_length - L))
        tag = enc.codes[p:p + L].copy()
        if (tag >= 4).any():
            continue
        for _ in range(int(rng.integers(0, 3))):
            tag[rng.integers(0, L)] = rng.integers(0, 4)
        tags.append(tag)
    return tags + [rng.integers(0, 4, 36).astype(np.uint8) for _ in range(2)]


@pytest.mark.parametrize("e", [0, 1, 2])
def test_tagerator_long_tags_match_reference(e, tmp_path):
    """Tags of 32-40 bp: the batched engines equal the reference's
    per-tag DFS row for row, and the CLI (-esa and -pck) prints what the
    reference's CLI prints."""
    from genometools_tpu.cli import main as ref_main
    from genometools_tpu.core.encseq import Encseq as REncseq
    from genometools_tpu.index.esa import load_esa as rload
    from genometools_tpu.match.querysearch import tagerator_search
    from genometools_torch.index.esa import load_esa
    from genometools_torch.match import querysearch as tq
    enc = TEncseq.load(str(ATINSERT))
    esa = load_esa(str(ATINSERT), encseq=enc)
    resa = rload(str(ATINSERT), encseq=REncseq.load(str(ATINSERT)))
    fm = tfm.fmindex_from_codes(enc.codes[::-1].copy(), device="cpu")
    tags = _long_tags(enc, 30 + e)
    a = tq.esa_tagerator_batch(esa, tags, e)
    b = tfm.pck_tagerator_batch(fm, tags, e, enc.total_length, device="cpu")
    for i, tag in enumerate(tags):
        assert a[i] == tagerator_search(resa, tag, e), i
        assert sorted(b[i]) == sorted(a[i]), i
    assert sum(map(len, a)) > 0
    q = tmp_path / "long.fna"
    q.write_text("".join(f">l{i}\n{enc.alphabet.decode(t)}\n"
                         for i, t in enumerate(tags)))
    for route in ("-esa", "-pck"):
        argv = ["tagerator", "-e", str(e), "-q", str(q), route,
                str(ATINSERT)]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ref_main(argv + ["--cpu"])
        assert _cli(argv) == buf.getvalue(), route


def test_approximate_search_matches_reference():
    from genometools_tpu.core.encseq import Encseq as REncseq
    from genometools_tpu.index.esa import build_esa as rbuild
    from genometools_tpu.match.querysearch import approximate_search
    from genometools_torch.match import querysearch as tq
    text = _text(5, 600, 0.02)
    t, r = TEncseq.from_string(text), REncseq.from_string(text)
    tesa = tbuild(t, with_lcp=False, device="cpu")
    resa = rbuild(r, with_lcp=False)
    rng = np.random.default_rng(5)
    for _ in range(6):
        p = int(rng.integers(0, t.total_length - 10))
        pat = t.codes[p:p + 10].copy()
        if (pat >= 4).any():
            continue
        pat[3] = (pat[3] + 1) % 4
        for best in (False, True):
            assert tq.approximate_search(tesa, pat, 1, best) == \
                approximate_search(resa, pat, 1, best)


def test_prebwt_matches_reference(tmp_path):
    from genometools_tpu.index.fmindex import fmindex_from_codes as rfc
    import itertools
    enc = TEncseq.load(str(ATINSERT))
    enc.save(str(tmp_path / "pck"))
    _cli(["prebwt", "-pck", str(tmp_path / "pck"), "-maxdepth", "4"])
    got = json.loads((tmp_path / "pck.pbt").read_text())
    # the reference's route: one backward search per code
    fm = rfc(enc.codes[::-1].copy())
    bounds = {}
    for depth in range(1, 5):
        for code in itertools.product(range(4), repeat=depth):
            lo, hi = fm.backward_search(np.asarray(code, np.uint8))
            if hi > lo:
                bounds["".join(map(str, code))] = [int(lo), int(hi)]
    assert (tmp_path / "pck.pbt").read_text() == json.dumps(
        {"maxdepth": 4, "bounds": bounds})
    assert got["bounds"] == tfm.prebwt_bounds(
        tfm.fmindex_from_codes(enc.codes[::-1].copy(), device="cpu"), 4,
        device="cpu")


def test_mergeesa_and_sain_match_reference(tmp_path, monkeypatch):
    from genometools_tpu.core.encseq import Encseq as REncseq
    from genometools_tpu.core.native import sais_native
    from genometools_tpu.index.esa import merge_esas, write_esa
    dbs = ["Atinsert.fna", "Duplicate.fna"]
    # the .esq holds the index's name as given: both write "m" in their
    # own directory
    (tmp_path / "ref").mkdir()
    monkeypatch.chdir(tmp_path / "ref")
    ref = merge_esas([REncseq.load(str(GOLDEN / d / "idx")) for d in dbs])
    ref.encseq.save("m")
    write_esa(ref, "m", suf=True, lcp=True)
    monkeypatch.chdir(tmp_path)
    _cli(["mergeesa", "-indexname", "m", "-ii"] +
         [str(GOLDEN / d / "idx") for d in dbs])
    for ext in ("suf", "lcp", "llv", "prj", "esq", "ssp", "des"):
        a, b = tmp_path / f"m.{ext}", tmp_path / "ref" / f"m.{ext}"
        assert a.exists() == b.exists(), ext
        if a.exists():
            assert a.read_bytes() == b.read_bytes(), ext
    _cli(["sain", "-esa", "m", "-check", "-suf", "-indexname", "s"])
    enc = REncseq.load("m")
    want = sais_native(enc.suffix_keys()).astype(np.uint64)
    assert (tmp_path / "s.suf").read_bytes() == want.tobytes()
    assert (tmp_path / "s.suf").read_bytes() == \
        (tmp_path / "m.suf").read_bytes()


def test_packedindex_cli(tmp_path):
    """mkindex writes the FM index, the encseq and, with -bdx, a .bdx
    the chkintegrity route verifies; chkintegrity verifies gt's rev.bdx
    with -dir 1 and refuses a .bdx of another text."""
    import shutil
    _cli(["packedindex", "mkindex", "-ii", str(ATINSERT), "-indexname",
          str(tmp_path / "p"), "-bdx"])
    fm = tfm.FMIndex.load(str(tmp_path / "p"))
    enc = TEncseq.load(str(tmp_path / "p"))
    assert np.array_equal(fm.bwt, tbuild(enc, with_lcp=False,
                                         device="cpu").bwt())
    _cli(["packedindex", "chkintegrity", "-ii", str(tmp_path / "p")])
    for ext in ("esq", "ssp", "des", "sds", "prj"):
        src = GOLDEN / "Random.fna" / f"idx.{ext}"
        if src.exists():
            shutil.copy(src, tmp_path / f"rnd.{ext}")
    shutil.copy(GBDX / "rev.bdx", tmp_path / "rnd.bdx")
    _cli(["packedindex", "chkintegrity", "-ii", str(tmp_path / "rnd"),
          "-dir", "1"])
    shutil.copy(GBDX / "ttt.bdx", tmp_path / "rnd.bdx")
    from genometools_torch.cli import main
    with contextlib.redirect_stderr(io.StringIO()):
        assert main(["packedindex", "chkintegrity", "-ii",
                     str(tmp_path / "rnd"), "-dir", "1",
                     "-device", "cpu"]) == 1


def test_device_codes_cached_and_kmer_codes_take_them():
    from genometools_torch.ops.kmer import kmer_codes
    enc = TEncseq.load(str(GOLDEN / "Duplicate.fna" / "idx"))
    c = enc.device_codes(0, "cpu")
    assert c is enc.device_codes(0, "cpu")
    assert c.dtype == torch.uint8 and np.array_equal(c.numpy(), enc.codes)
    assert np.array_equal(enc.device_codes(1, "cpu").numpy(),
                          enc.codes_view(1))
    k = enc.device_suffix_keys(0, "cpu")
    assert np.array_equal(k.numpy(), enc.suffix_keys(0))
    a, va = kmer_codes(c, 11, device="cpu")
    b, vb = kmer_codes(enc.codes, 11, device="cpu")
    assert torch.equal(a, b) and torch.equal(va, vb)
