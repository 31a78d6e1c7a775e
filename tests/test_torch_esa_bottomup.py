"""genometools_torch's repfind engine: the bottom-up lcp-interval walk
over the port's build_esa against gt's own `dev sfxmap` output
(tests/golden_lcpitv, written by the compiled gt binary), and the
maximal-pairs walks (native in memory, native from the index files,
native streamed, the Python oracle) against each other and against the
reference package. Every comparison is exact."""

import io
from pathlib import Path

import numpy as np
import pytest
import torch

from genometools_torch.index.esa import build_esa, load_esa, write_esa
from genometools_torch.index.seqread import SequentialSuffixArrayReader
from genometools_torch.match import esa_bottomup as eb
from genometools_torch.match import maxpairs as tmp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden_esa"
LCPITV = ROOT / "tests" / "golden_lcpitv"


def _enc(db):
    from genometools_torch.core.encseq import Encseq
    return Encseq.load(str(GOLDEN / db / "idx"))


def _sfxmap(enc, mode) -> str:
    """The lines `gt dev sfxmap -<mode>` prints for enc, from the port's
    build_esa on the CPU (as the reference's cmd_dev_sfxmap prints them,
    genometools_tpu/cli.py:3305-3317)."""
    esa = build_esa(enc, device="cpu")
    sa = esa.suftab.astype(np.int64)
    lcp = np.asarray(esa.lcptab, np.int64)
    nonspecials = enc.total_length - enc.special_ranges.total
    out = io.StringIO()
    if mode == "enumlcpitvs":
        eb.esa_bottomup(sa, lcp, nonspecials, eb.LcpIntervalPrinter(out))
        out.write(f"N 0 0 {enc.total_length}\n")   # the closing root
    elif mode == "enumlcpitvtree":
        eb.esa_bottomup(sa, lcp, nonspecials, eb.LcpTreePrinter(out))
    else:
        v = eb.SpmitvsVisitor(enc)
        eb.esa_bottomup(sa, lcp, nonspecials, v)
        v.print_results(nonspecials, out)
    return out.getvalue()


@pytest.mark.parametrize("db,mode", [
    ("Duplicate.fna", "enumlcpitvs"), ("Duplicate.fna", "enumlcpitvtree"),
    ("Duplicate.fna", "spmitv"), ("Atinsert.fna", "spmitv")])
def test_walk_matches_gt_golden(db, mode):
    want = (LCPITV / f"{db.split('.')[0]}.{mode}").read_text()
    assert _sfxmap(_enc(db), mode) == want


@pytest.mark.parametrize("db,minlen", [("Duplicate.fna", 8),
                                       ("Atinsert.fna", 8),
                                       ("Atinsert.fna", 14),
                                       ("small_poly.fas", 2)])
def test_maxpairs_walks_agree(db, minlen):
    """The native walk equals the Python walk (its oracle) pair for pair
    and in order, and the reference's enumerate_maxpairs over its ESA of
    the same text (built by its host SA-IS and Kasai engines)."""
    from genometools_tpu.core.encseq import Encseq as RefEncseq
    from genometools_tpu.core.native import kasai_lcp_native, sais_native
    from genometools_tpu.index.esa import EnhancedSuffixArray
    from genometools_tpu.match.maxpairs import \
        enumerate_maxpairs as ref_enumerate
    enc = _enc(db)
    esa = build_esa(enc, device="cpu")
    got = tmp.enumerate_maxpairs(esa, minlen)
    cls = tmp.left_context_classes(esa)
    oracle = tmp._maxpairs_py(esa.suftab, esa.lcptab, cls, minlen,
                              enc.alphabet.num_chars)
    renc = RefEncseq.load(str(GOLDEN / db / "idx"))
    keys = renc.suffix_keys()
    sa = sais_native(keys)
    ref = ref_enumerate(EnhancedSuffixArray(
        renc, 0, sa, kasai_lcp_native(keys, sa)), minlen)
    for a, b, c in zip((got.pos1, got.pos2, got.length), oracle,
                       (ref.pos1, ref.pos2, ref.length)):
        assert np.array_equal(a, b)
        assert np.array_equal(a, np.asarray(c))
    assert got.count > 0


@pytest.mark.parametrize("source", ["files", "esa", "parts"])
def test_stream_routes_match_in_memory(source, tmp_path):
    """The streamed walk over the index files, over the ESA in chunks
    and over the host parts engine (no suffix table in memory), and the
    file-fed walk, all equal the in-memory walk."""
    enc = _enc("Atinsert.fna")
    esa = build_esa(enc, device="cpu")
    want = tmp.enumerate_maxpairs(esa, 8).canonical()
    idx = str(tmp_path / "idx")
    write_esa(esa, idx)
    if source == "files":
        rd = SequentialSuffixArrayReader.from_files(idx, chunk=1000)
        files = tmp.enumerate_maxpairs_files(idx, enc, 8)
        assert np.array_equal(files.canonical(), want)
    elif source == "esa":
        rd = SequentialSuffixArrayReader.from_esa(esa, chunk=777)
    else:
        rd = SequentialSuffixArrayReader.from_parts(enc.codes, 3000)
    got = tmp.enumerate_maxpairs_stream(rd, enc, 8)
    assert np.array_equal(got.canonical(), want) and want.size


def test_load_esa_matches_build(tmp_path):
    """load_esa reads back what write_esa wrote, in every suftab form."""
    enc = _enc("Duplicate.fna")
    esa = build_esa(enc, device="cpu")
    idx = str(tmp_path / "idx")
    write_esa(esa, idx)
    for signed in (True, "i32"):
        got = load_esa(idx, encseq=enc, signed_suftab=signed)
        assert np.array_equal(got.suftab, esa.suftab)
        assert np.array_equal(got.lcptab, esa.lcptab)
    assert load_esa(idx, encseq=enc, need_lcp=False).lcptab is None


def test_enumerate_maxpairs_raises_without_the_native_walk(monkeypatch):
    from genometools_torch.core import native
    esa = build_esa(_enc("Duplicate.fna"), device="cpu")
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError):
        tmp.enumerate_maxpairs(esa, 8)
