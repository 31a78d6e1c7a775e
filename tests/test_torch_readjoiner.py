"""genometools_torch readjoiner and encseq2spm against the reference
package on the CPU: contained reads (every route), SPMs (the native and
the numpy join, irreducible or not), the .spm bytes, the string graph's
reductions and contigs (also against gt's tests/golden_readjoiner_red),
the contigs graph, GFA/ASQG, read correction, and the prefilter ->
overlap -> assembly and cgraph pipeline through both CLIs, file for
file. Every comparison is exact."""

import contextlib
import io
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from genometools_torch.assembly import readjoiner as pr

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RED = ROOT / "tests" / "golden_readjoiner_red"


def _ref():
    from genometools_tpu.assembly import readjoiner as rr
    return rr


def _sim_reads(seed=5, glen=6000, n=1500, varlen=False):
    """Error-free reads of a random genome, half reverse-complemented;
    with varlen, lengths 30-120 and some reads cut from others."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, glen).astype(np.uint8)
    reads = []
    for _ in range(n):
        L = int(rng.integers(30, 121)) if varlen else 100
        p = int(rng.integers(0, glen - L))
        r = genome[p:p + L].copy()
        if rng.random() < 0.5:
            r = (3 - r[::-1]).astype(np.uint8)
        reads.append(r)
    if varlen:
        for i in range(0, n, 50):
            src = reads[(i + 7) % n]
            reads[i] = src[3:3 + max(10, src.size // 2)].copy()
    return reads, genome


def _both(reads):
    return pr.ReadSet([r.copy() for r in reads]), \
        _ref().ReadSet([r.copy() for r in reads])


def _write_fasta(reads, path):
    lut = np.frombuffer(b"acgt", np.uint8)
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b">r%d\n" % i + lut[r].tobytes() + b"\n")


@pytest.mark.parametrize("varlen", [False, True])
@pytest.mark.parametrize("singlestrand", [False, True])
def test_find_contained_matches_reference(varlen, singlestrand):
    """Equal-length reads (the void-view path) and variable-length reads
    (the suffix array and the per-read run scan)."""
    reads, _ = _sim_reads(varlen=varlen, n=800)
    rs, rrs = _both(reads)
    got = pr.find_contained(rs, singlestrand=singlestrand, device="cpu")
    want = _ref().find_contained(rrs, singlestrand=singlestrand)
    assert np.array_equal(got, want)
    assert got.any() and not got.all()


@pytest.mark.parametrize("varlen", [False, True])
def test_find_contained_sort_route(varlen, monkeypatch):
    """Without the native SA-IS the suffix sort runs through the port's
    build_suffix_array on the caller's device (here the CPU): the same
    mask as the native route."""
    from genometools_torch.core import native as pn
    from genometools_torch.index import suffix
    reads, _ = _sim_reads(seed=9, varlen=varlen, n=300)
    rs = pr.ReadSet(reads)
    want = pr.find_contained(rs, device="cpu")
    calls = []
    build = suffix.build_suffix_array
    monkeypatch.setattr(pn, "sais_native", lambda keys: None)
    monkeypatch.setattr(suffix, "build_suffix_array",
                        lambda *a, **k: calls.append(k) or build(*a, **k))
    got = pr.find_contained(pr.ReadSet(reads), device="cpu")
    assert np.array_equal(got, want) and got.any()
    if varlen:
        assert calls and calls[0]["device"] == "cpu"


def _spm_fields(s):
    return [np.asarray(getattr(s, f)) for f in
            ("suf_read", "suf_strand", "pref_read", "pref_strand", "length")]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("irreducible", [True, False])
@pytest.mark.parametrize("singlestrand", [False, True])
def test_find_spms_matches_reference(native, irreducible, singlestrand,
                                     monkeypatch):
    """The native join and the numpy join (spm_find_native disabled in
    both packages), irreducible or all, row for row."""
    if not native:
        from genometools_tpu.core import native as rn

        from genometools_torch.core import native as pn
        monkeypatch.setattr(pn, "spm_find_native", lambda *a, **k: None)
        monkeypatch.setattr(rn, "spm_find_native", lambda *a, **k: None)
    reads, _ = _sim_reads(seed=3, varlen=True, n=400, glen=3000)
    rs, rrs = _both(reads)
    got = pr.find_spms(rs, 20, singlestrand=singlestrand,
                       irreducible=irreducible)
    want = _ref().find_spms(rrs, 20, singlestrand=singlestrand,
                            irreducible=irreducible)
    for a, b in zip(_spm_fields(got), _spm_fields(want)):
        assert np.array_equal(a, b)
    assert got.length.size
    for sr, ss, p, ps, ln in list(zip(*_spm_fields(got)))[:200]:
        a = rs.reads[sr] if ss else rs.rc(sr)
        b = rs.reads[p] if ps else rs.rc(p)
        assert ln >= 20 and (a[a.size - ln:] == b[:ln]).all()


def test_spm_files_match_reference(tmp_path):
    """bin32, bin64 and text .spm bytes; the reader round-trips each."""
    reads, _ = _sim_reads(seed=4, n=600)
    rs, rrs = _both(reads)
    got = pr.find_spms(rs, 45)
    want = _ref().find_spms(rrs, 45)
    for bits in (32, 64):
        got.write_bin(str(tmp_path / f"p{bits}"), bits)
        want.write_bin(str(tmp_path / f"r{bits}"), bits)
        assert (tmp_path / f"p{bits}").read_bytes() == \
            (tmp_path / f"r{bits}").read_bytes()
        back = pr.SpmList.read(str(tmp_path / f"p{bits}"), 50)
        keep = got.length >= 50
        assert np.array_equal(back.length, got.length[keep])
    assert got.lines() == want.lines() and got.lines()
    (tmp_path / "t.spm").write_text("\n".join(got.lines()) + "\n")
    back = pr.SpmList.read(str(tmp_path / "t.spm"))
    assert back.lines() == got.lines()


def _red_pipeline(pkg):
    rs = pkg.ReadSet.from_files([str(RED / "reads.fna")])
    kw = {"device": "cpu"} if pkg is pr else {}
    contained = pkg.find_contained(rs, **kw)
    rs2 = pkg.ReadSet(reads=[rs.reads[i] for i in range(rs.num_reads)
                             if not contained[i]])
    spms = pkg.find_spms(rs2, 45)
    return rs2, spms


def test_reductions_and_contigs_match_golden_and_reference():
    """On gt's engineered read set: 63 reads kept, the p-bubble and
    dead-end counts of gt's logs, and every reduction count and contig
    equal to the reference's."""
    rs, spms = _red_pipeline(pr)
    rrs, rspms = _red_pipeline(_ref())
    assert rs.num_reads == 63
    counts = {}
    for pkg, r, s in ((pr, rs, spms), (_ref(), rrs, rspms)):
        g = pkg.StringGraph.from_spms(r, s)
        bub = sum(g.reduce_bubbles() for _ in range(3))
        g2 = pkg.StringGraph.from_spms(r, s)
        dead = sum(g2.reduce_dead_paths(10) for _ in range(10))
        g3 = pkg.StringGraph.from_spms(r, s)
        self_ = g3.reduce_self()
        trans = g3.reduce_transitive()
        contigs = g3.spell_contigs(min_length=100)
        g4 = pkg.StringGraph.from_spms(r, s)
        ec = g4.error_correction()
        counts[pkg] = (bub, dead, self_, trans, contigs, ec,
                       g4.spell_contigs(min_length=100), g3.edges)
    assert counts[pr] == counts[_ref()]
    bub, dead = counts[pr][:2]
    log = (RED / "bubble_only.log").read_text()
    assert bub == int(re.search(r"p-bubble edges \[\d+ rounds\] = (\d+)",
                                log).group(1))
    log = (RED / "deadend_only.log").read_text()
    assert dead == int(re.search(
        r"dead-end path edges \[\d+ rounds\] = (\d+)", log).group(1))
    assert counts[pr][4]


def test_graph_formats_and_correction_match_reference():
    """ContigsGraph (dot, paths), GFA 1 and 2, ASQG, correct_reads."""
    rs, spms = _red_pipeline(pr)
    rrs, rspms = _red_pipeline(_ref())
    cg = pr.ContigsGraph.from_assembly(rs, spms)
    rcg = _ref().ContigsGraph.from_assembly(rrs, rspms)
    assert cg.simplify() == rcg.simplify()
    assert cg.show_dot() == rcg.show_dot()
    assert cg.output_paths() == rcg.output_paths() and cg.output_paths()
    for v in (1, 2):
        assert pr.write_gfa(rs, spms, v) == _ref().write_gfa(rrs, rspms, v)
    assert pr.write_asqg(rs, spms) == _ref().write_asqg(rrs, rspms)
    reads, _ = _sim_reads(seed=6, glen=800, n=120)
    rng = np.random.default_rng(6)
    for i in range(0, 120, 10):
        reads[i][int(rng.integers(20, 80))] ^= 1
    rs, rrs = _both(reads)
    fixed, nfix = pr.correct_reads(rs)
    rfixed, rnfix = _ref().correct_reads(rrs)
    assert nfix == rnfix and nfix > 0
    assert np.array_equal(fixed.blob, rfixed.blob)


def _cli(main, argv, cwd):
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            main(argv)
    finally:
        os.chdir(old)
    return out.getvalue(), err.getvalue()


PIPELINE = [
    ["readjoiner", "prefilter", "-db", "reads.fna", "-readset", "rs"],
    ["readjoiner", "overlap", "-readset", "rs", "-l", "45"],
    ["readjoiner", "assembly", "-readset", "rs", "-l", "45"],
    ["readjoiner", "cgraph", "-readset", "rs"],
    ["readjoiner", "overlap", "-readset", "rs", "-l", "40",
     "-spmformat", "text"],
    ["readjoiner", "spmtest", "-db", "reads.fna", "-l", "50"],
]
FILES = ["rs.reads.npz", "rs.spm", "rs.contigs.fas", "rs.cgraph.dot",
         "rs.paths"]


@pytest.mark.parametrize("source", ["golden", "simulated"])
def test_cli_pipeline_matches_reference(source, tmp_path):
    """prefilter -> overlap -> assembly -> cgraph (and a text-format
    overlap, spmtest) through both CLIs: equal stdout and stderr, and
    every file byte-equal."""
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    outs = {}
    for who in ("ref", "port"):
        d = tmp_path / who
        d.mkdir()
        if source == "golden":
            (d / "reads.fna").write_bytes((RED / "reads.fna").read_bytes())
        else:
            _write_fasta(_sim_reads(seed=8, n=3000, glen=20000)[0],
                         d / "reads.fna")
        runs = []
        for argv in PIPELINE:
            if who == "port":
                runs.append(_cli(main, argv + ["-device", "cpu"], d))
            else:
                runs.append(_cli(ref_main, argv, d))
            if argv[1] == "cgraph":
                runs.append([(d / f).read_bytes() for f in FILES])
        outs[who] = runs
    assert outs["port"] == outs["ref"]
    assert b"contig_0" in outs["port"][4][2]


def test_encseq2spm_matches_reference(tmp_path):
    """encseq2spm -spm count and show over an index of simulated reads
    (the port's suffixerator writes the .esq)."""
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    _write_fasta(_sim_reads(seed=12, n=700, glen=9000)[0],
                 tmp_path / "reads.fna")
    _cli(main, ["suffixerator", "-db", "reads.fna", "-indexname", "rd",
                "-tis", "-device", "cpu"], tmp_path)
    for extra in (["-spm", "count"], ["-spm", "show"],
                  ["-spm", "count", "-singlestrand"]):
        argv = ["encseq2spm", "-ii", "rd", "-l", "45"] + extra
        got = _cli(main, argv + ["-device", "cpu"], tmp_path)
        want = _cli(ref_main, argv + ["--cpu"], tmp_path)
        assert got == want and got[0], extra
    count = int(got[0].split(":")[1])
    assert count > 0


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    from genometools_torch.cli import main
    if torch.cuda.is_available():
        return
    (tmp_path / "reads.fna").write_bytes((RED / "reads.fna").read_bytes())
    with pytest.raises(RuntimeError):
        _cli(main, PIPELINE[0], tmp_path)
