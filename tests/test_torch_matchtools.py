"""The port's match tools (chain2dim, congruence, matchtool,
linspace_align), the dev toolbox (sfxmap, show_seedext, sortbench,
paircmp, patternmatch, trieins, kmer_database, skproto) and the small
driver tools (wtree, clean, mmapandread, template) against the
reference's: each command through ``genometools_torch.cli.main`` and
``genometools_tpu.cli.main`` in this process on the same files, with
equal stdout, stderr, exit code (or the raised exception) and files.

Inputs: gt-written indexes from ``tests/golden_esa`` (read only), and
match files, fragment files and FASTA made here from numpy seeds.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from test_torch_anno import _run

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden_esa"
ATI = str(GOLDEN / "Atinsert.fna" / "idx")
RND = str(GOLDEN / "Random.fna" / "idx")


def _fragments(rng, n: int) -> str:
    lines = ["# start1 end1 start2 end2 weight"]
    for _ in range(n):
        s1, s2 = (int(x) for x in rng.integers(0, 5000, 2))
        ln = int(rng.integers(10, 200))
        w = f" {int(rng.integers(1, 300))}" if rng.random() < 0.7 else ""
        lines.append(f"{s1} {s1 + ln - 1} {s2} {s2 + ln + int(rng.integers(-5, 6))}"
                     f"{w}")
    return "\n".join(lines) + "\n"


def _open_matches(rng, n: int) -> str:
    lines = ["# OPENMATCH"]
    for _ in range(n):
        l1, l2 = (int(x) for x in rng.integers(20, 400, 2))
        lines.append(f"{l1} seq{int(rng.integers(0, 5))} "
                     f"{int(rng.integers(0, 9000))} F {l2} "
                     f"seq{int(rng.integers(0, 5))} "
                     f"{int(rng.integers(0, 9000))} {int(rng.integers(0, 9))}"
                     f" 1e-{int(rng.integers(2, 50))} "
                     f"{int(rng.integers(10, 900))} "
                     f"{rng.uniform(70, 100):.2f}")
    return "\n".join(lines) + "\n"


def _blast(rng, n: int) -> str:
    lines = ["# BLASTN 2.2.26", "# Query: q1", "# Fields: ..."]
    for i in range(n):
        qs, ss = (int(x) for x in rng.integers(1, 5000, 2))
        ln = int(rng.integers(20, 300))
        se = ss + ln if i % 2 else max(ss - ln, 1)
        lines.append(f"q{i % 4}\ts{i % 3}\t{rng.uniform(80, 100):.2f}\t{ln}"
                     f"\t{int(rng.integers(0, 9))}\t0\t{qs}\t{qs + ln}\t{ss}"
                     f"\t{se}\t{rng.uniform(0, 1e-5):.1e}"
                     f"\t{rng.uniform(40, 500):.1f}")
    return "\n".join(lines) + "\n"


def _query_fasta(rng) -> str:
    """Substrings of Atinsert with a few substitutions, and random
    sequence."""
    from genometools_torch.core.encseq import Encseq
    enc = Encseq.load(ATI)
    out = []
    for i in range(4):
        s = int(enc.seq_startpos(i))
        t = list(enc.extract_decoded(s + 20, s + 219))
        for p in rng.integers(0, len(t), 3):
            t[p] = "acgt"[int(rng.integers(0, 4))]
        out.append(f">q{i}\n{''.join(t)}\n")
    out.append(">r\n" + "".join("acgt"[i] for i in rng.integers(0, 4, 300))
               + "\n")
    return "".join(out)


def write_inputs(d: Path) -> None:
    rng = np.random.default_rng(31)
    (d / "frags.txt").write_text(_fragments(rng, 60))
    (d / "open.txt").write_text(_open_matches(rng, 40))
    (d / "badopen.txt").write_text("12 seq1 4 F 12 seq2\n")
    (d / "blast.txt").write_text(_blast(rng, 30))
    (d / "q.fna").write_text(_query_fasta(rng))
    (d / "empty.bin").write_bytes(b"")
    (d / "data.bin").write_bytes(rng.integers(0, 256, 3 << 20,
                                              dtype=np.uint8).tobytes())
    for ext in ("esq", "ssp", "des", "sds", "ois", "md5", "suf"):
        (d / f"junk.{ext}").write_bytes(b"x")


def _match_file(d: Path) -> None:
    """A seed_extend match file over Atinsert with the header lines
    show_seedext reads."""
    from genometools_torch.core.encseq import Encseq
    from genometools_torch.match.seed_extend import (SeedExtendParams,
                                                     seed_extend)
    p = SeedExtendParams(minidentity=80, userdefinedleastlength=30,
                         extension="xdrop")
    lines = [m.line() for m in seed_extend(Encseq.load(ATI), None, p,
                                           engine="fused")]
    (d / "m.txt").write_text(
        f"# Options: -ii {ATI} -l 30 -minidentity 80 -extendxdrop\n"
        "# Fields: s. len, s. seqnum, s. start, strand, q. len, q. seqnum, "
        "q. start, score, editdist, % identity\n" + "\n".join(lines) + "\n")
    (d / "noii.txt").write_text("# Fields: s. len\n")


CASES = {
    "chain2dim": [["chain2dim", "-m", "frags.txt"],
                  ["chain2dim", "-m", "frags.txt", "-local"],
                  ["chain2dim", "-m", "frags.txt", "-wf", "0.5"],
                  ["chain2dim", "-m", "frags.txt", "-local", "-wf", "1.5"]],
    "congruence": [["congruence", "spacedseed", "-esa", ATI, "-q",
                    "q.fna"],
                   ["congruence", "spacedseed", "-pck", ATI, "-q", "q.fna"],
                   ["congruence", "spacedseed", "-esa", ATI, "-q", "q.fna",
                    "-cmp", "-v"]],
    "matchtool": [["matchtool", "-matchfile", "open.txt"],
                  ["matchtool", "-matchfile", "blast.txt", "-type",
                   "BLASTOUT"],
                  ["matchtool", "-matchfile", "badopen.txt"],
                  ["matchtool", "-matchfile", "open.txt", "-type", "SW"]],
    "linspace_align": [["linspace_align", "-ss", "acgtacgtagct",
                        "acgacgtaagct"],
                       ["linspace_align", "-ss", "ttacgatcgatcga",
                        "acgatgatcgaat", "-local"],
                       ["linspace_align", "-ss", "acgtttttacgt", "acgtacgt",
                        "-affine"],
                       ["linspace_align", "-ss", "", "acgt"]],
    "dev_sfxmap": [["dev", "sfxmap", ATI, "-suf", "-lcp", "-tis"],
                   ["dev", "sfxmap", "-esa", ATI, "-enumlcpitvs"],
                   ["dev", "sfxmap", ATI, "-enumlcpitvtree"],
                   ["dev", "sfxmap", ATI, "-enumlcpitvtreeBU", "-spmitv"]],
    "dev_show_seedext": [["dev", "show_seedext", "-f", "m.txt"],
                         ["dev", "show_seedext", "-f", "m.txt", "-outfmt",
                          "alignment=70", "cigar", "cigarX", "-sortmatches"],
                         ["dev", "show_seedext", "-f", "m.txt", "-outfmt",
                          "evalue", "bitscore", "s.seqlen", "q.seqlen",
                          "-relax_polish"],
                         ["dev", "show_seedext", "-f", "noii.txt"]],
    "dev_paircmp": [["dev", "paircmp", "-ss", "acgtgac", "agtgacc", "-e"],
                    ["dev", "paircmp", "-a", "acg", "3"],
                    ["dev", "paircmp", "-ss", "acgtn", "acgtx"]],
    "dev_patternmatch": [["dev", "patternmatch", "-ii", ATI, "-samples",
                          "25"],
                         ["dev", "patternmatch", "-ii", RND, "-minpl", "5",
                          "-maxpl", "12", "-samples", "10"]],
    "dev_trieins": [["dev", "trieins", ATI], ["dev", "trieins", RND]],
    "dev_kmer_database": [["dev", "kmer_database", "-db", "q.fna",
                           "-kmersize", "6", "-verify"],
                          ["dev", "kmer_database", "-db", "q.fna",
                           "-kmersize", "5", "-cutoff", "2", "-verify"]],
    "wtree": [["wtree", ATI], ["wtree", ATI, "-rank", "2", "5000"],
              ["wtree", ATI, "-select", "1", "300"]],
    "clean": [["clean"]],
    "mmapandread": [["mmapandread", "data.bin", "empty.bin", "frags.txt"]],
    "template": [["template"], ["template", "-bool", "x.txt"]],
}


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _named(result):
    if isinstance(result, str):
        return result.replace("gt-tpu", "genometools_torch")
    if isinstance(result, (tuple, list)):
        return type(result)(_named(x) for x in result)
    return result


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_reference(case, tmp_path):
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    dirs = {}
    for side in ("ref", "port"):
        dirs[side] = tmp_path / side
        dirs[side].mkdir()
        write_inputs(dirs[side])
        if case == "dev_show_seedext":
            _match_file(dirs[side])
    for argv in CASES[case]:
        got = [_run(fn, argv, dirs[side])
               for side, fn in (("ref", ref_main), ("port", main))]
        if case == "dev_show_seedext":
            # the reference writes to the sys.stdout bound when its
            # module was first imported; its function runs here once
            # more with a stream of its own
            got[0] = _show_seedext_ref(argv, dirs["ref"], got[0])
        assert got[1] == _named(got[0]), argv
        assert _files(dirs["port"]) == _files(dirs["ref"]), argv
        rc, out, err = got[0][:3]
        assert out or err or rc not in (0, None) or \
            argv[0] in ("clean", "mmapandread"), argv
    if case == "clean":
        assert sorted(_files(dirs["port"])) == sorted(
            n for n in _files(tmp_path / "ref")) and \
            "junk.esq" not in _files(dirs["port"]) and \
            "junk.suf" in _files(dirs["port"])


def _show_seedext_ref(argv, d: Path, cli_result):
    import contextlib
    import io
    import os

    from genometools_tpu.match.show_seedext import show_seedext
    f = argv[argv.index("-f") + 1]
    outfmt = []
    if "-outfmt" in argv:
        for a in argv[argv.index("-outfmt") + 1:]:
            if a.startswith("-"):
                break
            outfmt.append(a)
    buf, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(d)
    try:
        with contextlib.redirect_stderr(err):
            rc = show_seedext(f, outfmt, sortmatches="-sortmatches" in argv,
                              out=buf)
    finally:
        os.chdir(old)
    assert rc == cli_result[0] and err.getvalue() == cli_result[2]
    return (rc, buf.getvalue(), err.getvalue(), cli_result[3])


def test_show_seedext_prints_alignments(tmp_path):
    from genometools_torch.cli import main
    write_inputs(tmp_path)
    _match_file(tmp_path)
    rc, out, _, _ = _run(main, ["dev", "show_seedext", "-f", "m.txt",
                                "-outfmt", "alignment", "cigar"], tmp_path)
    nmatch = len((tmp_path / "m.txt").read_text().splitlines()) - 2
    assert rc == 0 and nmatch > 0
    assert len(re.findall(r"^\d+ \d+ \d+ [FP] ", out, re.M)) == nmatch


def _time_masked(text: str) -> str:
    return re.sub(r"(# TIME .*) \d+\.\d\d$", r"\1 T", text, flags=re.M)


@pytest.mark.parametrize("argv", [
    ["-impl", "numpy", "-size", "5000", "-runs", "2", "-verify"],
    ["-impl", "device", "-size", "70000", "-maxvalue", "1000", "-verify"],
    ["-size", "1000", "-runs", "3"]], ids=["numpy", "device", "default"])
def test_dev_sortbench(argv, tmp_path):
    """The port sorts with torch.sort on -device (cpu here), the
    reference with jnp.sort; the lines are equal but for the times."""
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    ref = _run(ref_main, ["dev", "sortbench"] + argv + ["--cpu"], tmp_path)
    got = _run(main, ["dev", "sortbench"] + argv + ["-device", "cpu"],
               tmp_path)
    assert got[0] == ref[0] == 0
    assert _time_masked(got[1]) == _time_masked(ref[1])
    assert got[2:] == ref[2:]
    runs = int(argv[argv.index("-runs") + 1]) if "-runs" in argv else 1
    assert got[1].count("# TIME ") == runs
    assert ("# verified" in got[1]) == ("-verify" in argv)


def test_dev_skproto_names_the_ports_conventions(tmp_path):
    """skproto prints the reference's skeleton with the port's platform
    lines: -device (added by build_parser) where the reference's
    skeleton forces the platform and takes --cpu."""
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    for name in ([], ["newtool2"]):
        ref = _run(ref_main, ["dev", "skproto"] + name, tmp_path)
        got = _run(main, ["dev", "skproto"] + name, tmp_path)
        assert got[0] == ref[0] == 0 and got[2:] == ref[2:]
        want = ref[1].replace(
            "    _force_platform(args)\n",
            "    from .device import resolve_device\n"
            "    resolve_device(args.device)\n").replace(
            '    p.add_argument("--cpu", action="store_true")\n'
            "    p.set_defaults(func=cmd_", "    return p\n#").split("\n#")[0]
        assert got[1] == want + "\n"
        compile(got[1], "skeleton", "exec")
