"""genometools_torch tallymer against the reference package on the CPU:
the mer index bytes of both mkindex routes, search, occratio, the
streamed mkindex, the brute force, both CLI modes, and the device k-mer
scan kmer_codes against the reference's jitted scan. Every comparison is
exact (bytes, integers, lines)."""

import contextlib
import gzip
import io
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from genometools_torch.core.encseq import Encseq
from genometools_torch.index.esa import load_esa
from genometools_torch.index.seqread import SequentialSuffixArrayReader
from genometools_torch.match import tallymer as pt

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parents[1] / "tests" / "golden_esa"
KS = [2, 4, 11, 19, 31]
OCC = [(1, None), (2, 40)]


@pytest.fixture(scope="module")
def at1mb(tmp_path_factory):
    """The at1MB golden index with its .suf unpacked."""
    d = tmp_path_factory.mktemp("at1mb")
    for f in (GOLDEN / "at1MB").iterdir():
        if f.suffix == ".gz":
            if f.name == "idx.suf.gz":
                (d / "idx.suf").write_bytes(gzip.open(f).read())
        else:
            shutil.copy(f, d / f.name)
    return str(d / "idx")


def _files(name):
    return [Path(f"{name}.{ext}").read_bytes()
            for ext in ("mer", "mct", "tyr.json")]


@pytest.mark.parametrize("minocc,maxocc", OCC)
@pytest.mark.parametrize("k", KS)
def test_mkindex_bytes_match_reference(at1mb, tmp_path, k, minocc, maxocc):
    """Both routes write the reference's .mer/.mct/.tyr.json bytes."""
    from genometools_tpu.core.encseq import Encseq as RefEncseq
    from genometools_tpu.index.esa import load_esa as ref_load
    from genometools_tpu.match import tallymer as rt
    renc = RefEncseq.load(at1mb)
    enc = Encseq.load(at1mb)
    occ = dict(minocc=minocc, maxocc=maxocc)
    rt.mkindex_direct(renc, k, **occ).save(str(tmp_path / "ref_direct"))
    rt.mkindex(ref_load(at1mb, encseq=renc, need_lcp="small",
                        signed_suftab=False), k, **occ).save(
        str(tmp_path / "ref_esa"))
    pt.mkindex_direct(enc, k, **occ).save(str(tmp_path / "direct"))
    esa = load_esa(at1mb, encseq=enc, need_lcp="small", signed_suftab=False)
    assert esa.lcptab is None and esa.lcp_small.dtype == np.uint8
    mi = pt.mkindex(esa, k, **occ)
    mi.save(str(tmp_path / "esa"))
    want = _files(tmp_path / "ref_direct")
    assert _files(tmp_path / "ref_esa") == want
    assert _files(tmp_path / "direct") == want
    assert _files(tmp_path / "esa") == want
    if k == 4 and maxocc is None:
        # counts above 255 go to the .mct overflow table
        assert int(mi.counts.max()) > 255
        assert len(want[1]) > mi.num_mers
    if minocc == 1 and maxocc is None:
        bf = pt.mkindex_bruteforce(enc, k)
        assert np.array_equal(bf.mer_codes, mi.mer_codes)
        assert np.array_equal(bf.counts, mi.counts.astype(np.int64))


def test_mkindex_numpy_route_matches_native(at1mb, monkeypatch):
    """mkindex's numpy route (no native engine) equals the native walk
    and the reference's numpy route."""
    from genometools_tpu.core import native as rn
    from genometools_tpu.core.encseq import Encseq as RefEncseq
    from genometools_tpu.index.esa import load_esa as ref_load
    from genometools_tpu.match import tallymer as rt

    from genometools_torch.core import native as pn
    esa = load_esa(at1mb)
    want = pt.mkindex(esa, 19)
    renc = RefEncseq.load(at1mb)
    monkeypatch.setattr(pn, "tallymer_mkindex_native", lambda *a: None)
    monkeypatch.setattr(rn, "tallymer_mkindex_native", lambda *a: None)
    got = pt.mkindex(esa, 19, minocc=2)
    ref = rt.mkindex(ref_load(at1mb, encseq=renc), 19, minocc=2)
    assert np.array_equal(got.mer_codes, ref.mer_codes)
    assert np.array_equal(got.counts, ref.counts)
    keep = want.counts >= 2
    assert np.array_equal(got.mer_codes, want.mer_codes[keep])
    assert np.array_equal(got.counts, want.counts[keep])


@pytest.mark.parametrize("db,k,chunk", [("Atinsert.fna", 11, 97),
                                        ("Atinsert.fna", 11, 4096),
                                        ("at1MB", 19, 4096)])
def test_mkindex_stream_matches_mkindex(at1mb, db, k, chunk):
    """The streamed mkindex over chunks of the index files (a run carried
    across every chunk boundary) equals mkindex and the reference's
    streamed mkindex."""
    from genometools_tpu.core.encseq import Encseq as RefEncseq
    from genometools_tpu.index.seqread import \
        SequentialSuffixArrayReader as RefReader
    from genometools_tpu.match import tallymer as rt
    name = at1mb if db == "at1MB" else str(GOLDEN / db / "idx")
    enc = Encseq.load(name)
    got = pt.mkindex_stream(
        SequentialSuffixArrayReader.from_files(name, chunk=chunk), enc, k,
        minocc=2)
    want = pt.mkindex(load_esa(name, encseq=enc), k, minocc=2)
    ref = rt.mkindex_stream(RefReader.from_files(name, chunk=chunk),
                            RefEncseq.load(name), k, minocc=2)
    assert np.array_equal(got.mer_codes, want.mer_codes)
    assert np.array_equal(got.counts, want.counts.astype(np.int64))
    assert np.array_equal(got.mer_codes, ref.mer_codes)
    assert np.array_equal(got.counts, ref.counts)


@pytest.mark.parametrize("fwd,rev", [(True, False), (False, True),
                                     (True, True)])
@pytest.mark.parametrize("k", [11, 19])
def test_search_matches_reference(at1mb, tmp_path, k, fwd, rev):
    """search of Atinsert and trna_glutamine against at1MB's loaded
    (memory-mapped) index equals the reference's, field for field."""
    from genometools_tpu.core.encseq import Encseq as RefEncseq
    from genometools_tpu.match import tallymer as rt
    pt.mkindex_direct(Encseq.load(at1mb), k).save(str(tmp_path / "tyr"))
    mi, rmi = pt.MerIndex.load(str(tmp_path / "tyr")), \
        rt.MerIndex.load(str(tmp_path / "tyr"))
    hits = 0
    for q in ("Atinsert.fna", "trna_glutamine.fna"):
        got = pt.search(mi, Encseq.load(str(GOLDEN / q / "idx")), fwd, rev)
        want = rt.search(rmi, RefEncseq.load(str(GOLDEN / q / "idx")), fwd,
                         rev)
        for f in ("qseqnum", "qpos", "counts", "strand", "codes"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        hits += got.counts.size
    assert hits


def test_occratio_and_distribution_match_reference(at1mb):
    from genometools_tpu.core.encseq import Encseq as RefEncseq
    from genometools_tpu.index.esa import load_esa as ref_load
    from genometools_tpu.match import tallymer as rt
    esa = load_esa(at1mb)
    ref = ref_load(at1mb, encseq=RefEncseq.load(at1mb))
    assert pt.occratio(esa, 8, 12) == rt.occratio(ref, 8, 12)
    assert pt.occurrence_distribution(pt.mkindex(esa, 19)) == \
        rt.occurrence_distribution(rt.mkindex(ref, 19))


def test_bruteforce_and_bucket_directory_match_reference():
    from genometools_tpu.core.encseq import Encseq as RefEncseq
    from genometools_tpu.match import tallymer as rt
    name = str(GOLDEN / "Atinsert.fna" / "idx")
    got = pt.mkindex_bruteforce(Encseq.load(name), 9)
    want = rt.mkindex_bruteforce(RefEncseq.load(name), 9)
    assert np.array_equal(got.mer_codes, want.mer_codes)
    assert np.array_equal(got.counts, want.counts)
    pl, b = got.bucket_directory()
    rpl, rb = want.bucket_directory()
    assert pl == rpl and np.array_equal(b, rb)
    codes = np.arange(0, 4 ** 9, 977, dtype=np.int64)
    assert np.array_equal(pt._revcomp_codes(codes, 9),
                          rt._revcomp_codes(codes, 9))


def _run(main, argv, tmp_path, to_file=False):
    """A CLI's stdout; to_file routes it through a real file, so the
    search's native line writer takes it."""
    import os
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        if to_file:
            with open("out.txt", "w") as f, contextlib.redirect_stdout(f):
                main(argv)
            return Path("out.txt").read_text()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        return buf.getvalue()
    finally:
        os.chdir(cwd)


def test_cli_matches_reference(at1mb, tmp_path):
    """tallymer mkindex (index files and the histogram) and search
    (both output paths, the native line writer included) through both
    CLIs."""
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    q = str(GOLDEN / "Atinsert.fna" / "idx")
    lut = np.frombuffer(b"acgtn", np.uint8)
    for name, path in (("q.fna", q), ("at1MB.fna", at1mb)):
        enc = Encseq.load(path)
        with open(tmp_path / name, "wb") as f:
            for s in range(enc.num_sequences):
                lo, hi = int(enc.seq_startpos(s)), int(enc.seq_endpos(s))
                c = enc.codes[lo:hi + 1]
                f.write(b">" + enc.descs[s].encode("latin-1") + b"\n"
                        + lut[np.where(c < 4, c, 4)].tobytes() + b"\n")
    mk = ["tallymer", "mkindex", "-esa", at1mb, "-mersize", "19"]
    for sub, dev in (("ref", ["--cpu"]), ("port", ["-device", "cpu"])):
        m = ref_main if sub == "ref" else main
        hist = _run(m, mk + dev, tmp_path)
        _run(m, mk + ["-indexname", sub] + dev, tmp_path)
        if sub == "ref":
            want_hist = hist
    assert hist == want_hist and hist.startswith("1 ")
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    cases = [(["-strand", "fp", "-output", "qseqnum", "qpos", "counts",
               "sequence"], "q.fna", False),
             (["-output", "qpos", "counts"], "q.fna", False),
             (["-strand", "fp"], "at1MB.fna", True)]
    for extra, qf, to_file in cases:
        argv = ["tallymer", "search", "-tyr", "ref", "-q", qf] + extra
        want = _run(ref_main, argv + ["--cpu"], tmp_path, to_file)
        got = _run(main, argv + ["-device", "cpu"], tmp_path, to_file)
        assert got == want and want, extra
    assert len(want.splitlines()) > (1 << 14)


def test_cli_refuses_cpu_flag_and_needs_a_card(at1mb):
    from genometools_torch.cli import main
    with pytest.raises(SystemExit):
        main(["tallymer", "mkindex", "-esa", at1mb, "--cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            main(["tallymer", "mkindex", "-esa", at1mb])


@pytest.mark.parametrize("k", [1, 15, 16, 19, 31])
def test_kmer_codes_match_reference(k):
    """The device window scan on the CPU against the reference's jitted
    scan: the multi-word int32 codes and the validity mask, on sequences
    with wildcards and separators (one int64 word per window)."""
    import jax.numpy as jnp

    from genometools_tpu.ops.kmer import kmer_codes as ref_kmer_codes

    from genometools_torch.ops.kmer import (kmer_codes, kmer_codes64,
                                            kmer_codes_np, words_to_int)
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 700).astype(np.uint8)
    codes[rng.integers(0, 700, 12)] = 254
    codes[[150, 420]] = 255
    words, valid = kmer_codes(codes, k, device="cpu")
    rw, rv = ref_kmer_codes(jnp.asarray(codes), k)
    assert np.array_equal(words.numpy(), np.asarray(rw))
    assert np.array_equal(valid.numpy(), np.asarray(rv))
    code, v64 = kmer_codes64(torch.from_numpy(codes), k, device="cpu")
    npc, npv = kmer_codes_np(codes, k)
    assert np.array_equal(code.numpy(), npc)
    assert np.array_equal(v64.numpy(), npv)
    assert np.array_equal(words_to_int(words.numpy(), k), npc)
    assert not valid.all() and valid.any()


@pytest.mark.parametrize("k,num_chars", [(45, 4), (14, 20), (17, 20)])
def test_kmer_codes_wide_and_protein_match_reference(k, num_chars):
    """Windows wider than one int64 word (scanned word by word) and a
    20-letter alphabet, against the reference's jitted scan."""
    import jax.numpy as jnp

    from genometools_tpu.ops.kmer import kmer_codes as ref_kmer_codes

    from genometools_torch.ops.kmer import kmer_codes
    rng = np.random.default_rng(k)
    codes = rng.integers(0, num_chars, 400).astype(np.uint8)
    codes[rng.integers(0, 400, 6)] = 254
    codes[200] = 255
    words, valid = kmer_codes(codes, k, num_chars, device="cpu")
    rw, rv = ref_kmer_codes(jnp.asarray(codes), k, num_chars)
    assert np.array_equal(words.numpy(), np.asarray(rw))
    assert np.array_equal(valid.numpy(), np.asarray(rv))
