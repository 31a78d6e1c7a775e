"""genometools_torch repfind against the reference package on the CPU:
the forward, -r and -p rows, the extensions of the maximal pairs through
the seed_extend batches (the plain versions of K1, K2r and K3 here)
against the reference's per-pair host route, -q, and the CLI's bytes.
Every comparison is exact."""

import contextlib
import hashlib
import io
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from genometools_torch.core.encseq import Encseq
from genometools_torch.index.esa import build_esa, write_esa
from genometools_torch.match import repfind as tr

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parents[1] / "tests" / "golden_esa"
_REF_ESAS: dict = {}


def _ref_enc(db):
    from genometools_tpu.core.encseq import Encseq as RefEncseq
    return RefEncseq.load(str(GOLDEN / db / "idx"))


@pytest.fixture
def ref_repfind(monkeypatch):
    """The reference's repfind module with its ESAs built by its own
    host SA-IS and Kasai engines (a construction independent of the
    port's, and no JAX compile per text size), remembered by text."""
    from genometools_tpu.core.native import kasai_lcp_native, sais_native
    from genometools_tpu.index.esa import EnhancedSuffixArray
    from genometools_tpu.match import repfind as rr

    def host_build(enc, readmode=0):
        key = hashlib.sha1(enc.codes.tobytes()).hexdigest()
        if key not in _REF_ESAS:
            keys = enc.suffix_keys(readmode)
            sa = sais_native(keys)
            _REF_ESAS[key] = EnhancedSuffixArray(
                enc, readmode, sa, kasai_lcp_native(keys, sa))
        return _REF_ESAS[key]
    monkeypatch.setattr(rr, "build_esa", host_build)
    return rr


@pytest.mark.parametrize("db,minlen", [
    ("Duplicate.fna", 8), ("Duplicate.fna", 20), ("Atinsert.fna", 8),
    ("Atinsert.fna", 14), ("trna_glutamine.fna", 5),
    ("trna_glutamine.fna", 8), ("at1MB", 14), ("at1MB", 20)])
def test_rows_match_reference(ref_repfind, db, minlen):
    """Forward, -r and -p rows equal the reference's, in order; the -r
    and -p texts are sorted by the port's build_esa."""
    renc = _ref_enc(db)
    enc = Encseq.load(str(GOLDEN / db / "idx"))
    esa = build_esa(enc, device="cpu")
    for name in ("repfind_self", "repfind_reverse", "repfind_palindromic"):
        want = getattr(ref_repfind, name)(renc, minlen)
        got = getattr(tr, name)(enc, minlen, esa=esa, device="cpu")
        assert np.array_equal(got, want), name
    assert want.shape[1] == 6


@pytest.mark.parametrize("ext", ["greedy", "xdrop"])
def test_extend_matches_reference(ext, monkeypatch):
    """Duplicate -l 8 at the golden suite's 90/30/55: the batch route
    equals the reference's per-pair route and the port's host route,
    and the batch route extends no pair on the host route."""
    enc = Encseq.load(str(GOLDEN / "Duplicate.fna" / "idx"))
    kw = dict(minidentity=90, maxalignedlendifference=30,
              perc_mat_history=55)
    calls = []
    one = tr._extend_one_seed
    monkeypatch.setattr(tr, "_extend_one_seed",
                        lambda *a: calls.append(a) or one(*a))
    from genometools_tpu.match import repfind as rr
    want = [m.line() for m in rr.repfind_extend(
        _ref_enc("Duplicate.fna"), 8, ext, **kw)]
    got = [m.line() for m in tr.repfind_extend(enc, 8, ext, device="cpu",
                                               **kw)]
    assert got == want and want
    assert not calls
    host = [m.line() for m in tr.repfind_extend(enc, 8, ext, device="cpu",
                                                engine="host", **kw)]
    assert host == want and calls


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    from genometools_torch.utils.synthetic import planted_repeats, write_fasta
    fna = tmp_path_factory.mktemp("planted") / "g.fna"
    write_fasta(planted_repeats(seed=11, length=30_000, repeats=4,
                                replen=(2_000, 5_000), wildcard_runs=2), fna)
    return fna


@pytest.mark.parametrize("ext", ["greedy", "xdrop"])
def test_long_flanks_match_reference(planted, ext):
    """A small planted-repeat genome (2 x 30 kbp, repeats of 2-5 kbp) at
    -l 30: greedy flanks beyond K1's windows take the resident kernel's
    route, xdrop flanks beyond K3's 2,048 take its wide tiers (none goes
    to the host engine), and the matches equal the reference's."""
    from genometools_tpu.core.encseq import Encseq as RefEncseq

    from genometools_torch.ops import greedy_batch as gb
    from genometools_torch.ops import xdrop_batch as xb
    from genometools_tpu.match import repfind as rr
    gb.reset_stats()
    xb.reset_stats()
    want = [m.line() for m in rr.repfind_extend(
        RefEncseq.from_files([str(planted)]), 30, ext)]
    got = [m.line() for m in tr.repfind_extend(
        Encseq.from_files([str(planted)]), 30, ext, device="cpu")]
    assert got == want and want
    if ext == "greedy":
        assert gb.stats["resident_lanes"] > 0
    else:
        nt = len(xb.TIERS)
        assert xb.stats["host_lanes"] == xb.stats["host_symbols"] == 0
        assert xb.stats["wide_lanes"] > 0
        assert sum(xb.stats["tier_lanes"][nt:]) == xb.stats["wide_lanes"]


def test_cli_xdrop_sensitivity(tmp_path, capsys):
    """-extendxdrop N sets xdrop's belowscore (the output of the host
    route at that sensitivity); a greedy sensitivity other than 100 is
    refused."""
    from genometools_torch.cli import main
    from genometools_torch.ops.xdrop import optimal_xdrop_belowscore
    assert optimal_xdrop_belowscore(20, 90) != optimal_xdrop_belowscore(20, 97)
    enc = Encseq.load(str(GOLDEN / "Duplicate.fna" / "idx"))
    enc.save(str(tmp_path / "idx"))
    esa = build_esa(enc, device="cpu")
    write_esa(esa, str(tmp_path / "idx"))
    idx = str(tmp_path / "idx")
    for sens in (90, 97):
        capsys.readouterr()
        assert main(["repfind", "-l", "8", "-ii", idx, "-extendxdrop",
                     str(sens), "-device", "cpu"]) == 0
        want = [m.line() for m in tr.repfind_extend(
            enc, 8, "xdrop", minidentity=80, esa=esa, device="cpu",
            engine="host", sensitivity=sens)]
        assert capsys.readouterr().out.splitlines() == want and want
    with pytest.raises(SystemExit, match="-extendgreedy"):
        main(["repfind", "-l", "8", "-ii", idx, "-extendgreedy", "95",
              "-device", "cpu"])


def test_extend_checks_its_route():
    enc = Encseq.load(str(GOLDEN / "Duplicate.fna" / "idx"))
    with pytest.raises(ValueError):
        tr.repfind_extend(enc, 8, device="cpu", history=20)
    with pytest.raises(ValueError):
        tr.repfind_extend(enc, 8, device="cpu", engine="wave")
    assert tr.repfind_extend(enc, 8, device="cpu", engine="host",
                             history=20) is not None


def _query_enc(seed):
    """A query of pieces cut from Atinsert, some mutated, with random
    sequence between them."""
    enc = Encseq.load(str(GOLDEN / "Atinsert.fna" / "idx"))
    rng = np.random.default_rng(seed)
    txt = enc.alphabet.decode(enc.codes[enc.codes < 4])
    parts = []
    for _ in range(6):
        a = int(rng.integers(0, len(txt) - 200))
        piece = list(txt[a:a + int(rng.integers(40, 200))])
        for p in rng.integers(0, len(piece), 2):
            piece[p] = "acgt"[int(rng.integers(0, 4))]
        parts.append("".join(piece) + "".join(rng.choice(list("acgt"), 30)))
    return "|".join(parts)


def test_query_matches_reference():
    from genometools_tpu.core.encseq import Encseq as RefEncseq
    from genometools_tpu.index.esa import load_esa as ref_load
    from genometools_tpu.match.querysearch import \
        query_substring_matches as ref_qsm

    from genometools_torch.index.esa import load_esa
    from genometools_torch.match.querysearch import query_substring_matches
    q = _query_enc(3)
    idx = str(GOLDEN / "Atinsert.fna" / "idx")
    want = ref_qsm(ref_load(idx), RefEncseq.from_string(q), 12)
    got = query_substring_matches(load_esa(idx), Encseq.from_string(q), 12)
    assert got == want and want


CLI = [
    ["repfind", "-l", "8", "-ii", "idx"],
    ["repfind", "-l", "8", "-ii", "idx", "-f", "-r", "-p"],
    ["repfind", "-l", "14", "-ii", "idx", "-r"],
    ["repfind", "-l", "8", "-ii", "idx", "-extendgreedy",
     "-minidentity", "90"],
    ["repfind", "-l", "8", "-ii", "idx", "-extendxdrop"],
    ["repfind", "-l", "12", "-ii", "idx", "-q", "q.fna"],
]


@pytest.mark.parametrize("argv", CLI, ids=lambda a: "_".join(a[3:]))
def test_cli_bytes_match_reference(argv, tmp_path):
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    db = "Atinsert.fna" if "-q" in argv or "-r" in argv and \
        "-f" not in argv else "Duplicate.fna"
    enc = Encseq.load(str(GOLDEN / db / "idx"))
    enc.save(str(tmp_path / "idx"))
    write_esa(build_esa(enc, device="cpu"), str(tmp_path / "idx"))
    (tmp_path / "q.fna").write_text(
        "".join(f">q{i}\n{s}\n"
                for i, s in enumerate(_query_enc(5).split("|"))))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        out = []
        for run, extra in ((ref_main, ["--cpu"]), (main, ["-device", "cpu"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert run(argv + extra) == 0
            out.append(buf.getvalue())
    finally:
        os.chdir(cwd)
    assert out[1] == out[0] and out[0]
