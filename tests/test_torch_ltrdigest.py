"""ltrdigest in genometools_torch against the reference package.

The PBS batch (``pbs_find_batch``: every (element, strand window, tRNA)
lane of one call as one batch of torch ops, here on the CPU) against
the reference's ``pbs_find`` (one ``local_alignment`` at a time): every
field of every hit and the hits' order, on seeded cases that plant a
PBS on each strand, put ``n`` in the window, give two tRNAs equal
scores and one matrix equal-score cells, hold a tRNA shorter than the
tRNA-offset's upper end and an element too short for a window. Then
``ppt_find``, the library's ``ltrdigest`` on both engines, and the CLI
(stdout and the ``-outfileprefix`` files) against the reference's CLI on
the port's ltrharvest GFF3 of a small planted genome
(``utils/synthetic.py``, numpy seed 3). All comparisons are exact.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from genometools_torch.anno.genome_node import Range
from genometools_torch.ltr import ltrdigest as tld
from genometools_torch.utils.synthetic import (planted_transposons,
                                               trna_library, write_fasta)

torch.set_num_threads(1)

_ACGT = np.array(list("acgt"))


def _rs(rng, n):
    return "".join(_ACGT[rng.integers(0, 4, n)])


def _rc(s):
    return s[::-1].translate(str.maketrans("acgtn", "tgcan"))


def _hits(hits):
    return [(h.rng.start, h.rng.end, h.strand, h.trna, h.trna_offset,
             h.offset, h.edist, h.score) for h in hits]


def _elements(seed):
    """(elements as pbs_find takes them, tRNA library) of one seeded
    case: LTR-like elements with PBS planted on both strands, a run of
    n in one window, a duplicated tRNA (equal scores), a window that
    holds its PBS twice (equal-score cells in one matrix), a tRNA of 4
    bp and an element too short for a window."""
    rng = np.random.default_rng(seed)
    elems, lib = [], []
    for k in range(5):
        ltrlen = int(rng.integers(35, 90))
        ltr = _rs(rng, ltrlen)
        seq = ltr + _rs(rng, int(rng.integers(80, 200))) + ltr
        if k == 1:
            seq = seq[:ltrlen - 4] + "nnnnnn" + seq[ltrlen + 2:]
        if k == 2:
            # the 14 bp after the 5' LTR again 16 bp further on
            seq = seq[:ltrlen + 16] + seq[ltrlen:ltrlen + 14] + \
                seq[ltrlen + 30:]
        n = len(seq)
        fw = seq[ltrlen:ltrlen + int(rng.integers(12, 20))]
        rv = _rc(seq)[ltrlen:ltrlen + int(rng.integers(12, 20))]
        if k == 3:          # one substitution in the primer
            fw = fw[:5] + "acgt"[("acgt".index(fw[5]) + 1) % 4] + fw[6:]
        lib.append((f"fw{k}", _rs(rng, int(rng.integers(40, 70)))
                    + _rc(fw) + "cca"))
        lib.append((f"rv{k}", _rs(rng, int(rng.integers(40, 70)))
                    + _rc(rv) + "tcca"))
        elems.append((seq, Range(1, ltrlen), Range(n - ltrlen + 1, n),
                      1000 * (k + 1)))
    lib.append(("dup", lib[0][1]))
    lib.append(("tiny", "cgta"))
    lib.append(("random", _rs(rng, 80)))
    elems.append(("acgt" * 12, Range(1, 10), Range(39, 48), 7))
    return elems, lib


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pbs_batch_matches_reference(seed):
    from genometools_tpu.anno.genome_node import Range as RRange
    from genometools_tpu.ltr import ltrdigest as rld
    elems, lib = _elements(seed)
    trace = {}
    got = tld.pbs_find_batch(elems, lib, device="cpu", trace=trace)
    nhits = 0
    for (seq, l, r, start), g in zip(elems, got):
        ref = rld.pbs_find(seq, RRange(l.start, l.end),
                           RRange(r.start, r.end), start, lib)
        assert _hits(g) == _hits(ref)
        assert _hits(tld.pbs_find(seq, l, r, start, lib)) == _hits(ref)
        nhits += len(ref)
    assert trace["lanes"] == len(lib) * (2 * (len(elems) - 1))
    # the planted primers are found, on both strands
    strands = {h.strand for g in got for h in g}
    assert nhits >= 8 and strands == {"+", "-"}
    # the duplicated tRNA scores as its twin and stays behind it
    first = [h.trna for h in got[0] if h.trna in ("fw0", "dup")]
    assert first[:2] == ["fw0", "dup"]


@pytest.mark.parametrize("opts", [
    dict(chunk_bytes=1),                # one lane a chunk
    dict(chunk_bytes=200_000),          # 7 lanes a chunk at these shapes
    dict(params=tld.LTRdigestParams(pbs_radius=20, pbs_max_edist=3,
                                    pbs_alilen=(8, 40),
                                    pbs_offsetlen=(0, 12),
                                    pbs_trnaoffsetlen=(0, 9),
                                    pbs_match=3, pbs_mismatch=-4,
                                    pbs_insertion=-5)),
])
def test_pbs_batch_options(opts, monkeypatch):
    """Small chunks, other parameters."""
    from genometools_tpu.anno.genome_node import Range as RRange
    from genometools_tpu.ltr import ltrdigest as rld
    from genometools_tpu.ltr.ltrdigest import LTRdigestParams
    elems, lib = _elements(4)
    opts = dict(opts)
    if "chunk_bytes" in opts:
        monkeypatch.setitem(tld.CHUNK_BYTES, "cpu", opts.pop("chunk_bytes"))
    got = tld.pbs_find_batch(elems, lib, device="cpu", **opts)
    p = opts.get("params")
    rp = LTRdigestParams(**vars(p)) if p is not None else None
    for (seq, l, r, start), g in zip(elems, got):
        assert _hits(g) == _hits(rld.pbs_find(
            seq, RRange(l.start, l.end), RRange(r.start, r.end), start,
            lib, rp))


def _ref_row(window, trna_from3):
    """The reference's (score, ustart, uend, vstart, edist) of one lane,
    as its pbs_find aligns it."""
    from genometools_tpu.core.alphabet import dna_alphabet
    from genometools_tpu.match.alignment import local_alignment
    a = dna_alphabet()
    res = local_alignment(a.encode(window.encode()),
                          a.encode(trna_from3.encode()), 5, -10, -20)
    edist, ui, vi = 0, res.ustart, res.vstart
    for op, c in res.eops:
        for _ in range(c):
            if op == "M":
                edist += window[ui].lower() != trna_from3[vi].lower()
            edist += op != "M"
            ui += op != "I"
            vi += op != "D"
    return [res.score, res.ustart, res.uend, res.vstart, edist]


@pytest.mark.parametrize("seed", [11, 12])
def test_sw_lanes_match_local_alignment(seed):
    """The batch's raw rows, every lane (those with no hit too), against
    the reference's local_alignment: random windows and tRNAs of mixed
    lengths, some sharing a mutated stretch, upper case and n mixed in,
    and a tRNA of n that matches nothing."""
    from genometools_torch.core.alphabet import dna_alphabet
    rng = np.random.default_rng(seed)
    wins, trnas = [], []
    for k in range(24):
        w = _rs(rng, 61)
        t = _rs(rng, int(rng.integers(4, 90)))
        if k % 3 and len(t) > 20:
            a, n = int(rng.integers(0, 40)), int(rng.integers(6, 20))
            b = int(rng.integers(0, len(t) - n))
            part = list(w[a:a + n])
            part[int(rng.integers(0, n))] = "acgtn"[int(rng.integers(0, 5))]
            t = t[:b] + "".join(part) + t[b + n:]
        if k % 4 == 1:
            w = w[:20] + w[20:40].upper() + "n" + w[41:]
        if k == 0:          # a wildcard tRNA: no match, score 0
            t = "n" * 6
        wins.append(w)
        trnas.append(t)
    al, ids = dna_alphabet(), {}
    V = max(map(len, trnas))

    def pad(s, fill):
        c = np.full(V, fill, np.int32)
        c[:len(s)] = al.encode(s.encode())
        return c

    def pad_ids(s):
        c = np.full(V, -1, np.int32)
        c[:len(s)] = tld._symbol_ids(s, ids)
        return c

    out = tld._sw_lanes(
        torch.from_numpy(np.stack([al.encode(w.encode()).astype(np.int32)
                                   for w in wins])),
        torch.from_numpy(np.stack([pad(t, 255) for t in trnas])),
        torch.tensor([len(t) for t in trnas]),
        torch.from_numpy(np.stack([tld._symbol_ids(w, ids) for w in wins])),
        torch.from_numpy(np.stack([pad_ids(t) for t in trnas])),
        tld.LTRdigestParams(), {})
    want = [_ref_row(w, t) for w, t in zip(wins, trnas)]
    assert out.tolist() == want
    assert sum(r[0] == 0 for r in want) and sum(r[4] > 0 for r in want)
    # the port's host lane is the same row
    assert [list(tld.pbs_align(w, t, tld.LTRdigestParams()))
            for w, t in zip(wins, trnas)] == want


def test_equal_score_cells_take_the_first():
    """A window holding the primer twice: the best cell is the first
    maximum in row-major order, as local_alignment keeps it."""
    from genometools_tpu.match.alignment import local_alignment
    from genometools_torch.core.alphabet import dna_alphabet
    rng = np.random.default_rng(5)
    p = _rs(rng, 12)
    w = _rs(rng, 10) + p + _rs(rng, 5) + p + _rs(rng, 34)
    v = _rs(rng, 3) + p + _rs(rng, 40)
    a = dna_alphabet()
    u8, v8 = a.encode(w.encode()), a.encode(v.encode())
    ref = local_alignment(u8, v8, 5, -10, -20)
    ids = {}
    out = tld._sw_lanes(
        torch.from_numpy(u8.astype(np.int32))[None],
        torch.from_numpy(v8.astype(np.int32))[None],
        torch.tensor([len(v)]), torch.from_numpy(tld._symbol_ids(w, ids))[None],
        torch.from_numpy(tld._symbol_ids(v, ids))[None],
        tld.LTRdigestParams(), {})
    assert out[0].tolist() == [ref.score, ref.ustart, ref.uend, ref.vstart, 0]
    assert ref.ustart == 10 and ref.score == 60


def test_no_lanes_and_no_card():
    assert tld.pbs_find_batch([("acgt" * 5, Range(1, 5), Range(16, 20), 1)],
                              [("t", "acgt" * 20)], device="cpu") == [[]]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tld.pbs_find_batch([], [], device="cuda")


@pytest.mark.parametrize("seed", [1, 2])
def test_ppt_find_matches_reference(seed):
    from genometools_tpu.anno.genome_node import Range as RRange
    from genometools_tpu.ltr import ltrdigest as rld
    rng = np.random.default_rng(seed)
    found = 0
    for _ in range(6):
        ltrlen = int(rng.integers(30, 120))
        inner = _rs(rng, int(rng.integers(100, 400)))
        # a purine-rich tract before the 3' LTR
        inner = inner[:-40] + "".join(rng.choice(list("ag"), 20)) + \
            "ttttt" + inner[-15:]
        ltr = _rs(rng, ltrlen)
        seq = ltr + inner + ltr
        n = len(seq)
        for params in (None, rld.LTRdigestParams(ppt_radius=20,
                                                  max_ubox_dist=5)):
            tp = tld.LTRdigestParams(**vars(params)) if params else None
            r = rld.ppt_find(seq, RRange(501, 500 + ltrlen),
                             RRange(500 + n - ltrlen + 1, 500 + n), 501,
                             params)
            t = tld.ppt_find(seq, Range(501, 500 + ltrlen),
                             Range(500 + n - ltrlen + 1, 500 + n), 501, tp)
            assert [(h.rng.start, h.rng.end, h.strand, h.score,
                     h.ubox and (h.ubox.start, h.ubox.end)) for h in t] == \
                [(h.rng.start, h.rng.end, h.strand, h.score,
                  h.ubox and (h.ubox.start, h.ubox.end)) for h in r]
            found += len(r)
    assert found >= 6


# ---------------------------------------------------------------------------
# ltrdigest on the port's ltrharvest GFF3 of a planted genome
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def annotated(tmp_path_factory):
    from genometools_torch.anno.gff3 import gff3_to_string
    from genometools_torch.core.encseq import Encseq
    from genometools_torch.ltr.ltrharvest import (LTRHarvestParams,
                                                  gff3_nodes, ltrharvest)
    d = tmp_path_factory.mktemp("ltrdigest")
    seqs, planted = planted_transposons(seed=3, nseq=2, length=60000, ltr=3,
                                        tir=1, wildcard_runs=2)
    write_fasta(seqs, d / "g.fa", "chr")
    enc = Encseq.from_string("|".join(s.decode() for s in seqs))
    enc.descs = ["chr_0", "chr_1"]
    preds = ltrharvest(enc, LTRHarvestParams(with_tsd=True), device="cpu")
    (d / "lh.gff3").write_text(gff3_to_string(gff3_nodes(preds, enc, True)))
    enc.save(str(d / "idx"))
    lib, pairs = trna_library(seqs, planted, seed=5, n=16, planted_n=3)
    with open(d / "trna.fa", "w") as f:
        for name, s in lib:
            f.write(f">{name} tRNA-like\n{s}\n")
    (d / "other.gff3").write_text(
        "##gff-version 3\nchrX\tLTRharvest\tLTR_retrotransposon\t1\t500\t.\t"
        "?\t.\tID=e\nchrX\tLTRharvest\tlong_terminal_repeat\t1\t100\t.\t?\t"
        ".\tParent=e\nchrX\tLTRharvest\tlong_terminal_repeat\t401\t500\t.\t"
        "?\t.\tParent=e\n")
    assert len(preds) >= 3 and pairs.shape == (3, 2)
    return d


def _nodes(gff3_mod, d):
    return gff3_mod.parse_gff3((d / "lh.gff3").read_text())


def _trnas(d):
    from genometools_torch.core.seqio import read_seqfile
    ss = read_seqfile(str(d / "trna.fa"))
    return [(x.split()[0], s.tobytes().decode())
            for x, s in zip(ss.descs, ss.seqs)]


def test_engines_agree_with_reference(annotated):
    from genometools_tpu.anno import gff3 as rg
    from genometools_tpu.anno.cds import RegionMapping as RMap
    from genometools_tpu.ltr import ltrdigest as rld

    from genometools_torch.anno import gff3 as tg
    from genometools_torch.anno.cds import RegionMapping
    d = annotated
    lib = _trnas(d)
    ref = rg.gff3_to_string(rld.ltrdigest(
        _nodes(rg, d), RMap.from_file(str(d / "g.fa")), lib),
        retainids=True)
    mapping = RegionMapping.from_file(str(d / "g.fa"))
    trace = {}
    batch = tg.gff3_to_string(tld.ltrdigest(
        _nodes(tg, d), mapping, lib, device="cpu", trace=trace),
        retainids=True)
    host = tg.gff3_to_string(tld.ltrdigest(
        _nodes(tg, d), mapping, lib, engine="host"), retainids=True)
    assert batch == host == ref
    assert "primer_binding_site" in ref
    assert trace["lanes"] == 2 * len(lib) * trace["elements"]


# each command as the port runs it (with -device cpu)
CLI = [
    ["ltrdigest", "-trnas", "trna.fa", "-seqfile", "g.fa", "lh.gff3"],
    ["ltrdigest", "-trnas", "trna.fa", "-seqfile", "g.fa",
     "-outfileprefix", "out", "lh.gff3"],
    ["ltrdigest", "-seqfile", "g.fa", "-outfileprefix", "noppt",
     "-seqnamelen", "3", "lh.gff3"],
    ["ltrdigest", "-trnas", "trna.fa", "-encseq", "idx", "-matchdesc",
     "-pbsradius", "20", "-pbsmaxedist", "2", "-pbsalilen", "10", "40",
     "-pbsoffset", "0", "8", "-pbstrnaoffset", "0", "7", "-pptlen", "6",
     "20", "-uboxlen", "2", "20", "-pptradius", "25", "-maxgaplen", "3",
     "lh.gff3"],
    ["ltrdigest", "-trnas", "trna.fa", "-seqfile", "g.fa", "other.gff3"],
]
OUTFILES = ("tabout.csv", "5ltr.fas", "3ltr.fas", "complete.fas", "ppt.fas",
            "pbs.fas")


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("k", range(len(CLI)))
def test_cli_matches_reference(annotated, k):
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    argv = CLI[k]
    cwd = os.getcwd()
    os.chdir(annotated)
    try:
        prefix = argv[argv.index("-outfileprefix") + 1] \
            if "-outfileprefix" in argv else None
        ref = _run(ref_main, argv)
        files = {x: (annotated / f"{prefix}_{x}").read_bytes()
                 for x in OUTFILES} if prefix else {}
        got = _run(main, argv + ["-device", "cpu"])
    finally:
        os.chdir(cwd)
    assert got == ref
    for x, body in files.items():
        assert (annotated / f"{prefix}_{x}").read_bytes() == body, x
    if k < 4:
        assert ref[0] == 0 and "LTR_retrotransposon" in ref[1]
        assert ("primer_binding_site" in ref[1]) == ("-trnas" in argv)
    else:
        assert ref[0] == 1 and "gt ltrdigest: error:" in ref[2]


def test_cli_asks_for_the_card(annotated):
    from genometools_torch.cli import main
    if torch.cuda.is_available():
        pytest.skip("a card is attached")
    for argv in (CLI[0], CLI[2]):       # also without -trnas
        with pytest.raises(RuntimeError, match="is_available"):
            main([a if not a.endswith((".fa", ".gff3")) else
                  str(annotated / a) for a in argv])


def test_trna_library_plants_primers():
    seqs, planted = planted_transposons(seed=3, nseq=2, length=60000, ltr=3,
                                        tir=1, wildcard_runs=2)
    lib, pairs = trna_library(seqs, planted, seed=5, n=16, planted_n=3)
    assert len(lib) == 16 and all(s.endswith("cca") and 72 <= len(s) <= 90
                                  for _, s in lib)
    for slot, row in pairs:
        _, s, _, e1 = planted[row][:4]
        pbs = seqs[s][e1 + 1:e1 + 19].decode()
        assert lib[slot][1][-21:-3] == _rc(pbs)
    assert trna_library(seqs, planted, seed=5, n=16, planted_n=3)[0] == lib
