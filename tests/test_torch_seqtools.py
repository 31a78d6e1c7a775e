"""The port's sequence tools against the reference's: seqstat, encseq
encode|decode|info, convertseq, seq, splitfasta, fastq_sample,
seqtransform, magicmatch, compreads, condenseq, seqorder and the seqtool
family (extractseq, shredder, sequniq, seqfilter, simreads, mutate,
seqmutate, seqtranslate, fingerprint). Each command runs through
``genometools_torch.cli.main`` and ``genometools_tpu.cli.main`` in this
process on the same files, with equal stdout, stderr, exit code (or the
raised exception) and written files.

The inputs are made here: FASTA of the gt-written indexes in
``tests/golden_esa`` (Duplicate, the first 40 sequences of at1MB), and
random sequences, reads and FASTQ from numpy seeds. The random tools use
the reference's generators and seeds, so their outputs are equal byte
for byte; each runs at two settings. Last, BASELINE config 4 end to end
at Duplicate's size: encseq decode, suffixerator, shredder, suffixerator
-tis of the reads and seed_extend -extendxdrop all against all.
"""

import random
from pathlib import Path

import numpy as np
import pytest

from test_torch_anno import _run

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden_esa"
_ACGT = np.array(list("acgt"))


def _wrap(s: str, width: int = 60) -> str:
    return "".join(s[i:i + width] + "\n" for i in range(0, len(s), width))


def _index_fasta(db: str, first: int | None = None) -> str:
    from genometools_torch.core.encseq import Encseq
    enc = Encseq.load(str(GOLDEN / db / "idx"))
    out = []
    for i in range(min(first or enc.num_sequences, enc.num_sequences)):
        start, n = int(enc.seq_startpos(i)), int(enc.seq_length(i))
        out.append(">" + enc.descs[i] + "\n" +
                   _wrap(enc.extract_decoded(start, start + n - 1)))
    return "".join(out)


def _rand(rng, n: int) -> str:
    return "".join(_ACGT[rng.integers(0, 4, n)])


def _revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("acgt", "tgca"))


def write_inputs(d: Path) -> None:
    """The test files of one side (ref or port), the same on both."""
    (d / "at.fna").write_text(_index_fasta("at1MB", 40))
    (d / "dup.fna").write_text(_index_fasta("Duplicate.fna"))
    rng = np.random.default_rng(11)
    rnd = []
    for i in range(10):
        s = list(_rand(rng, int(rng.integers(80, 400))))
        if i % 3 == 0:
            for p in rng.integers(0, len(s), 3):
                s[p] = "n"
        rnd.append(f">rnd{i} random sequence {i}\n" + _wrap("".join(s)))
    (d / "rnd.fna").write_text("".join(rnd))
    # duplicates and reverse complements for sequniq and fingerprint
    base = [_rand(rng, int(rng.integers(50, 150))) for _ in range(6)]
    seqs = base + [base[1], base[4], _revcomp(base[2]), base[1].upper()]
    (d / "dupl.fna").write_text("".join(
        f">d{i}\n{s}\n" for i, s in enumerate(seqs)))
    aminos = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    (d / "prot.fa").write_text("".join(
        f">p{i}\n" + _wrap("".join(aminos[rng.integers(0, 20, 70 + i)]),
                           50) for i in range(5)) + ">dnaonly\nacgtacgt\n")
    (d / "short.fna").write_text(">s1\nac\n>s2\nacgtagcatgacgatttag\n")
    reads = []
    for i in range(30):
        n = int(rng.integers(40, 90))
        q = "".join(chr(33 + int(x)) for x in rng.integers(0, 41, n))
        reads.append(f"@read{i} lane 1\n{_rand(rng, n)}\n+\n{q}\n")
    (d / "reads.fq").write_text("".join(reads))
    # a redundant set for condenseq: copies of a base with substitutions
    core = _rand(rng, 800)
    rep = []
    for i in range(8):
        s = list(core[i * 30:i * 30 + 300])
        for p in rng.integers(0, len(s), 4):
            s[p] = "acgt"[int(rng.integers(0, 4))]
        rep.append(f">rep{i}\n" + _wrap("".join(s)))
    rep.append(">unique\n" + _wrap(_rand(rng, 200)))
    (d / "rep.fna").write_text("".join(rep))
    (d / "q.fna").write_text(f">q0\n{core[100:140]}\n>q1\n{core[400:430]}"
                             f"\n>q2\n{_rand(rng, 35)}\n")
    (d / "pipe.fna").write_text(">ab|k1|x\nacgtacgtac\n>cd|k0|y\nttttgggg\n"
                                ">ef|k2|z\naaaaccccggggtttt\n")
    (d / "keys.txt").write_text("k2\nk0 2 5\nk1\n")
    (d / "badkeys.txt").write_text("k2 5\n")
    (d / "atkeys.txt").write_text("4714047 10 60\n4714049\n")
    (d / "fp.txt").write_text("0123456789abcdef0123456789abcdef\n")
    (d / "sd").mkdir()


CASES = {
    "seqstat": [["seqstat", "at.fna"], ["seqstat", "dup.fna", "rnd.fna"]],
    "encseq": [["encseq", "encode", "at.fna", "-indexname", "enc"],
               ["encseq", "info", "enc"], ["encseq", "decode", "enc"],
               ["encseq", "encode", "rnd.fna"], ["encseq", "info", "rnd.fna"],
               ["encseq", "decode", str(GOLDEN / "Duplicate.fna" / "idx")],
               ["encseq", "info", str(GOLDEN / "at1MB" / "idx")]],
    "convertseq": [["convertseq", "at.fna"],
                   ["convertseq", "-r", "-fastawidth", "50", "dup.fna"],
                   ["convertseq", "-noseq", "-showfilelengthvalues",
                    "at.fna", "rnd.fna"]],
    "seq": [["seq", "at.fna"], ["seq", "-stat", "at.fna"],
            ["seq", "-showfasta", "-width", "70", "dup.fna"],
            ["seq", "-showseqnum", "3", "at.fna"],
            ["seq", "-showseqnum", "99", "dup.fna"]],
    "splitfasta": [["splitfasta", "-numfiles", "3", "at.fna"],
                   ["splitfasta", "-numfiles", "3", "at.fna"],
                   ["splitfasta", "-numfiles", "2", "-force", "at.fna"],
                   ["splitfasta", "-targetsize", "1", "dup.fna"],
                   ["splitfasta", "-splitdesc", "sd", "rnd.fna"],
                   ["splitfasta", "reads.fq"]],
    "seqtransform": [["seqtransform", "prot.fa", "-addstopaminos",
                      "-width", "30"], ["seqtransform", "at.fna"]],
    "magicmatch": [["magicmatch", "-f", "at.fna", "dup.fna"]],
    "compreads": [["compreads", "compress", "-files", "reads.fq", "-name",
                   "c"],
                  ["compreads", "decompress", "-file", "c", "-name", "d"],
                  ["compreads", "decompress", "-file", "c"]],
    "condenseq": [["condenseq", "compress", "-indexname", "cq",
                   "-kmersize", "12", "rep.fna"],
                  ["condenseq", "info", "cq"], ["condenseq", "extract", "cq"],
                  ["condenseq", "extract", "cq", "-sequences", "0", "8"],
                  ["condenseq", "search", "-query", "q.fna", "cq"]],
    "seqorder": [["seqorder", f"-{m}", str(GOLDEN / "Atinsert.fna" / "idx")]
                 for m in ("sort", "revsort", "sorthdr", "sorthdrnum",
                           "sortlength", "invert", "shuffle")] +
                [["seqorder", "-sort", "rnd.fna"],
                 ["seqorder", "-sort", "-invert", "rnd.fna"]],
    "extractseq": [["extractseq", "-frompos", "10", "-topos", "100",
                    "dup.fna"],
                   ["extractseq", "-frompos", "850", "-topos", "900",
                    "-width", "20", "dup.fna"],
                   ["extractseq", "-match", "Motohashi R.*clone 8", "at.fna"],
                   ["extractseq", "-keys", "atkeys.txt", "-width", "60",
                    "at.fna"],
                   ["extractseq", "-keys", "keys.txt", "pipe.fna"],
                   ["extractseq", "-keys", "badkeys.txt", "pipe.fna"],
                   ["extractseq", "-frompos", "10", "dup.fna"],
                   ["extractseq", "-frompos", "100", "-topos", "10",
                    "dup.fna"],
                   ["extractseq", "-frompos", "1", "-topos", "99999",
                    "dup.fna"]],
    "shredder": [["shredder", "dup.fna"],
                 ["shredder", "-minlength", "50", "-maxlength", "120",
                  "-overlap", "10", "-coverage", "2", "at.fna"],
                 ["shredder", "-sample", "0.5", "-clipdesc", "-width", "60",
                  "at.fna"],
                 ["shredder", "-minlength", "10", "-maxlength", "5",
                  "at.fna"]],
    "sequniq": [["sequniq", "dupl.fna"], ["sequniq", "-rev", "dupl.fna"]],
    "seqfilter": [["seqfilter", "-minlength", "300", "at.fna"],
                  ["seqfilter", "-maxlength", "500", "-maxseqnum", "4",
                   "-step", "2", "at.fna"],
                  ["seqfilter", "-sample", "0.3", "at.fna"],
                  ["seqfilter", "-nowildcards", "rnd.fna"]],
    "simreads": [["simreads", "-num", "20", "-length", "50", "dup.fna"],
                 ["simreads", "-coverage", "2", "-length", "80", "-width",
                  "60", "at.fna"]],
    "mutate": [["mutate", "-rate", "5", "dup.fna"], ["mutate", "at.fna"]],
    "seqmutate": [["seqmutate", "-rate", "10", "-width", "60", "dup.fna"],
                  ["seqmutate", "rnd.fna"]],
    "seqtranslate": [["seqtranslate", "at.fna"],
                     ["seqtranslate", "-fastawidth", "30", "short.fna"]],
    "fingerprint": [["fingerprint", "at.fna"],
                    ["fingerprint", "-duplicates", "dupl.fna"],
                    ["fingerprint", "-duplicates", "at.fna"],
                    ["fingerprint", "-check", "fp.txt", "dup.fna"],
                    ["fingerprint", "-extract", "@FP", "-width", "60",
                     "at.fna"]],
}
# cases that print and write nothing
QUIET = (("fingerprint", "-duplicates", "at.fna"),)


def _argv(argv, side):
    """The port's device tools take -device cpu; the reference's
    suffixerator and seed_extend --cpu (its seqorder takes neither)."""
    if side == "port" and argv[0] in ("seqorder", "suffixerator",
                                      "seed_extend"):
        return argv + ["-device", "cpu"]
    if side == "ref" and argv[0] in ("suffixerator", "seed_extend"):
        return argv + ["--cpu"]
    return argv


def _named(result):
    """A result with the reference's program name mapped onto the
    port's."""
    if isinstance(result, str):
        return result.replace("gt-tpu", "genometools_torch")
    if isinstance(result, (tuple, list)):
        return type(result)(_named(x) for x in result)
    return result


def _files(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def _sides(tmp_path):
    dirs = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        write_inputs(d)
        dirs[side] = d
    return dirs


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_reference(case, tmp_path):
    from genometools_tpu.cli import main as ref_main
    from genometools_tpu.core.seqio import read_seqfiles
    from genometools_tpu.utils.seqtools import fingerprints

    from genometools_torch.cli import main
    dirs = _sides(tmp_path)
    fp = fingerprints(read_seqfiles([str(dirs["ref"] / "at.fna")]))[3]
    for argv in CASES[case]:
        argv = [fp if a == "@FP" else a for a in argv]
        got = [_run(fn, _argv(argv, side), dirs[side])
               for side, fn in (("ref", ref_main), ("port", main))]
        assert got[1] == _named(got[0]), argv
        assert _files(dirs["port"]) == _files(dirs["ref"]), argv
        rc, out, err = got[0][:3]
        assert out or err or rc not in (0, None) or \
            argv[0] in ("splitfasta", "compreads") or \
            argv[:2] == ["encseq", "encode"] or tuple(argv) in QUIET, argv


def test_seqtools_write_what_they_say(tmp_path):
    """Spot checks that the cases exercise the tools: splitfasta writes
    its pieces, encseq decode of Duplicate is the FASTA of its golden,
    shredder's pieces tile the sequences, condenseq round-trips."""
    from genometools_torch.cli import main
    d = _sides(tmp_path)["port"]
    assert _run(main, ["splitfasta", "-numfiles", "3", "at.fna"], d)[0] == 0
    pieces = [d / f"at.fna.{i}" for i in (1, 2, 3)]
    assert b"".join(p.read_bytes() for p in pieces) == \
        (d / "at.fna").read_bytes()
    rc, out, _, _ = _run(main, ["encseq", "decode", str(
        GOLDEN / "Duplicate.fna" / "idx")], d)
    want = (d / "dup.fna").read_text()
    assert rc == 0 and out.upper().replace("\n", "") == \
        want.upper().replace("\n", "")
    rc, out, _, _ = _run(main, ["shredder", "dup.fna"], d)
    reads = out.split(">")[1:]
    assert rc == 0 and len(reads) >= 2
    assert all(300 <= len(r.split("\n", 1)[1].replace("\n", "")) <= 700
               for r in reads[:-1] if not r.startswith(reads[-1][:10]))
    _run(main, ["condenseq", "compress", "-indexname", "cq", "-kmersize",
                "12", "rep.fna"], d)
    rc, out, _, _ = _run(main, ["condenseq", "extract", "cq"], d)
    assert out.replace("\n", "").lower().count("rep") == 8


@pytest.mark.parametrize("seed", [3, 2024])
@pytest.mark.parametrize("length", ["700", "100000"])
def test_fastq_sample_matches_reference(seed, length, tmp_path,
                                        monkeypatch):
    """fastq_sample draws from an unseeded random.Random in the
    reference; both packages run here with random.Random seeded alike."""
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    dirs = _sides(tmp_path)
    base = random.Random

    class Seeded(base):
        def __init__(self, x=None):
            super().__init__(seed)

    monkeypatch.setattr(random, "Random", Seeded)
    argv = ["fastq_sample", "-length", length, "reads.fq"]
    got = [_run(fn, argv, dirs[side])
           for side, fn in (("ref", ref_main), ("port", main))]
    assert got[1] == got[0]
    if length == "700":
        assert got[0][0] == 0 and got[0][1].startswith("total length ")
    else:
        assert got[0][0] == 1 and "exceeds length" in got[0][2]


def test_extractseq_bad_pattern(tmp_path):
    """An invalid -match pattern: the port prints the reference's
    message for it and exits 1; the reference's CLI names re.error
    without importing re, so it raises NameError there instead."""
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    dirs = _sides(tmp_path)
    argv = ["extractseq", "-match", "(", "at.fna"]
    ref = _run(ref_main, argv, dirs["ref"])
    got = _run(main, argv, dirs["port"])
    assert ref[0][:2] == ("raised", "NameError")
    assert got[0] == 1 and got[1] == ""
    assert got[2].startswith("gt extractseq: error: invalid pattern: ")


def test_seqorder_sort_matches_suftab(tmp_path):
    """-sort lists the sequences in the order of their start suffixes in
    gt's own suftab; -revsort reverses it."""
    from genometools_torch.cli import main
    idx = GOLDEN / "Atinsert.fna" / "idx"
    from genometools_torch.core.encseq import Encseq
    enc = Encseq.load(str(idx))
    sa = np.fromfile(str(idx) + ".suf", np.uint64).astype(np.int64)
    starts = {int(enc.seq_startpos(i)): i for i in range(enc.num_sequences)}
    want = [enc.descs[starts[p]] for p in sa if int(p) in starts]
    outs = {}
    for mode in ("sort", "revsort"):
        rc, out, _, _ = _run(main, ["seqorder", f"-{mode}", str(idx),
                                    "-device", "cpu"], tmp_path)
        assert rc == 0
        outs[mode] = [l[1:] for l in out.splitlines() if l.startswith(">")]
    assert outs["sort"] == want
    assert outs["revsort"] == want[::-1]


def test_baseline_config4_end_to_end(tmp_path):
    """BASELINE config 4 at Duplicate's size through both CLIs: decode
    the golden, index it (.suf/.lcp equal to gt's), shred it with the
    reference's defaults, index the reads and run seed_extend -extendxdrop
    all against all; every step's output and files equal."""
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    steps = [
        ["encseq", "decode", str(GOLDEN / "Duplicate.fna" / "idx")],
        ["suffixerator", "-db", "Duplicate.fna", "-indexname", "dup",
         "-suf", "-lcp", "-tis"],
        ["shredder", "Duplicate.fna"],
        ["suffixerator", "-db", "reads.fna", "-indexname", "reads",
         "-tis"],
        ["seed_extend", "-ii", "reads", "-extendxdrop", "-l", "20",
         "-minidentity", "80"],
    ]
    lines = {}
    for side, fn in (("ref", ref_main), ("port", main)):
        d = tmp_path / side
        d.mkdir()
        outs = []
        for argv in steps:
            rc, out, err, _ = _run(fn, _argv(argv, side), d)
            assert rc == 0, (side, argv, err)
            outs.append(out)
            if argv[0] == "encseq":
                (d / "Duplicate.fna").write_text(out)
            if argv[0] == "shredder":
                (d / "reads.fna").write_text(out)
        lines[side] = outs
        for ext in ("suf", "lcp"):
            assert (d / f"dup.{ext}").read_bytes() == \
                (GOLDEN / "Duplicate.fna" / f"idx.{ext}").read_bytes()
    assert lines["port"] == lines["ref"]
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    matches = [l for l in lines["port"][-1].splitlines()
               if l and not l.startswith("#")]
    assert len(matches) > 0
