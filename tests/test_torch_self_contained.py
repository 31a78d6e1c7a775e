"""genometools_torch stands alone: no module of the port, and not
chip_smoke.py, imports the reference package or JAX, and the port's
suffixerator (in memory, with -parts and with -dist), suffixerator_e2e,
seed_extend (with -parts, -dist, -maxmat and -estim), repfind, tallymer mkindex|search,
readjoiner prefilter|overlap|assembly, genomediff, ltrharvest, tirvish,
ltrclustering, packedindex mkindex, prebwt, tagerator (-esa and -pck),
mergeesa, sain, ltrdigest (with -outfileprefix) and the annotation tools
(gff3 -sort, gff3validator, stat, extractfeat) run in a process where
both are blocked, printing what the reference's CLI prints for the same
arguments and writing the same files."""

import ast
import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden_esa"
READS = ROOT / "tests" / "golden_readjoiner_red" / "reads.fna"
TAGS = ROOT / "tests" / "golden_tagerator" / "tags.fna"
BLOCKED = ("jax", "genometools_tpu")


def _imported(path: Path):
    """Top-level names of every absolute import in a source file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_the_reference_or_jax():
    files = sorted((ROOT / "genometools_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imported(p) if m in BLOCKED]
    assert len(files) > 30
    assert not bad, bad


# each command as the port runs it; the reference takes --cpu instead
# of -device cpu
COMMANDS = [
    ["suffixerator", "-db", "in.fa", "-indexname", "idx", "-suf", "-lcp",
     "-tis"],
    ["suffixerator", "-db", "in.fa", "-indexname", "parts", "-suf", "-lcp",
     "-tis", "-parts", "2"],
    ["suffixerator", "-db", "in.fa", "-indexname", "dist", "-suf", "-lcp",
     "-tis", "-dist", "2"],
    ["seed_extend", "-ii", "idx", "-l", "14", "-minidentity", "90",
     "-extendgreedy", "-outfmt", "alignment"],
    ["seed_extend", "-ii", "idx", "-l", "14", "-minidentity", "90",
     "-extendxdrop", "-outfmt", "evalue", "bitscore"],
    ["seed_extend", "-ii", "idx", "-l", "14", "-minidentity", "90",
     "-parts", "2"],
    ["seed_extend", "-ii", "idx", "-l", "14", "-minidentity", "90",
     "-dist", "2", "-parts", "3"],
    ["seed_extend", "-ii", "idx", "-l", "20", "-maxmat"],
    ["seed_extend", "-ii", "idx", "-estim", "ANI"],
    ["repfind", "-l", "8", "-ii", "idx", "-f", "-r", "-p"],
    ["repfind", "-l", "8", "-ii", "idx", "-extendgreedy", "-minidentity",
     "90"],
    ["repfind", "-l", "8", "-ii", "idx", "-extendxdrop"],
    ["tallymer", "mkindex", "-esa", "idx", "-mersize", "11"],
    ["tallymer", "mkindex", "-esa", "idx", "-mersize", "11", "-indexname",
     "tyr"],
    ["tallymer", "search", "-tyr", "tyr", "-q", "in.fa", "-strand", "fp",
     "-output", "qseqnum", "qpos", "counts", "sequence"],
    ["readjoiner", "prefilter", "-db", "reads.fna", "-readset", "rj"],
    ["readjoiner", "overlap", "-readset", "rj", "-l", "45"],
    ["readjoiner", "assembly", "-readset", "rj", "-l", "45"],
    ["genomediff", "in.fa", "in2.fa"],
    ["suffixerator", "-db", "ltr.fa", "-indexname", "ltr", "-suf", "-lcp",
     "-tis", "-des", "-sds", "-ssp"],
    ["ltrharvest", "-index", "ltr", "-longoutput"],
    ["ltrharvest", "-index", "ltr", "-gff3", "-seqids", "-out", "lh.fas",
     "-outinner", "lh.inner.fas"],
    ["ltrharvest", "-index", "ltr", "-gff3", "lh.gff3", "-tabout", "no"],
    ["tirvish", "-index", "ltr"],
    ["ltrclustering", "-psmall", "80", "-plarge", "30", "ltr", "lh.gff3"],
    ["packedindex", "mkindex", "-db", "in.fa", "-indexname", "pck"],
    ["prebwt", "-pck", "pck", "-maxdepth", "3"],
    ["tagerator", "-q", "tags.fna", "-esa", "idx", "-e", "1"],
    ["tagerator", "-q", "tags.fna", "-pck", "idx", "-e", "1", "-best"],
    ["mergeesa", "-indexname", "mrg", "-ii", "idx", "ltr"],
    ["sain", "-esa", "idx", "-check", "-suf", "-indexname", "sn"],
    ["ltrharvest", "-index", "ltr", "-gff3", "lhs.gff3", "-seqids",
     "-tabout", "no"],
    ["gff3", "-sort", "-retainids", "lhs.gff3"],
    ["gff3validator", "lhs.gff3"],
    ["stat", "lhs.gff3"],
    ["ltrdigest", "-trnas", "trna.fa", "-seqfile", "ltr.fa",
     "-outfileprefix", "ld", "lhs.gff3"],
    ["extractfeat", "lhs.gff3", "-type", "LTR_retrotransposon", "-seqfile",
     "ltr.fa"],
]
# the annotation tools take no -device in the port and no --cpu in the
# reference; ltrdigest takes -device in the port only
HOST_TOOLS = ("gff3", "gff3validator", "stat", "extractfeat")
# files the commands write: the reference writes its own under _ref names
WRITTEN = {"tyr": ("mer", "mct", "tyr.json"),
           "rj": ("reads.npz", "spm", "contigs.fas"),
           "pck": ("fmi.json", "pbt"),
           "mrg": ("suf", "lcp", "prj"),
           "sn": ("suf",)}
# files named whole on the command line, written or read under _ref names
FILES = ("lh.fas", "lh.inner.fas", "lh.gff3", "lhs.gff3")
# ltrdigest -outfileprefix: the reference writes <prefix>_ref_<name>
PREFIXED = {"ld": ("tabout.csv", "5ltr.fas", "3ltr.fas", "complete.fas",
                   "ppt.fas", "pbs.fas")}
# tools whose output is files only
QUIET = ("readjoiner", "prebwt", "sain", "packedindex", "mergeesa")


def _ref_arg(a: str) -> str:
    if a in WRITTEN or a in PREFIXED:
        return a + "_ref"
    if a in FILES:
        stem, dot, ext = a.partition(".")
        return f"{stem}_ref{dot}{ext}"
    return a


def test_cli_runs_with_reference_and_jax_blocked(tmp_path):
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.core.encseq import Encseq
    lut = np.frombuffer(b"acgtn", np.uint8)
    for db, name in (("Duplicate.fna", "in.fa"), ("Random159.fna", "in2.fa")):
        enc = Encseq.load(str(GOLDEN / db / "idx"))
        with open(tmp_path / name, "wb") as f:
            for s in range(enc.num_sequences):
                lo, hi = int(enc.seq_startpos(s)), int(enc.seq_endpos(s))
                c = enc.codes[lo:hi + 1]
                f.write(b">" + enc.descs[s].encode("latin-1") + b"\n")
                f.write(lut[np.where(c < 4, c, 4)].tobytes() + b"\n")
    (tmp_path / "reads.fna").write_bytes(READS.read_bytes())
    (tmp_path / "tags.fna").write_bytes(TAGS.read_bytes())
    from genometools_torch.utils.synthetic import (planted_transposons,
                                                   trna_library, write_fasta)
    seqs, planted = planted_transposons(seed=3, nseq=2, length=40000, ltr=2,
                                        tir=2, wildcard_runs=2)
    write_fasta(seqs, tmp_path / "ltr.fa", "chr")
    with open(tmp_path / "trna.fa", "w") as f:
        for name, s in trna_library(seqs, planted, n=12, planted_n=2)[0]:
            f.write(f">{name}\n{s}\n")
    script = (
        "import sys\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in BLOCKED) +
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from genometools_torch.cli import main\n"
        "from genometools_torch.index.fastpipe import suffixerator_e2e\n"
        "from genometools_torch.utils import progressbar, spacepeak\n"
        f"for argv in {COMMANDS!r}:\n"
        f"    main(argv + ([] if argv[0] in {HOST_TOOLS!r} else "
        "['-device', 'cpu']))\n"
        "    print('#--', flush=True)\n"
        "suffixerator_e2e(['in.fa'], 'e2e', device='cpu')\n"
        f"assert all(sys.modules[m] is None for m in {BLOCKED!r})\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    got = out.stdout.split("#--\n")[:len(COMMANDS)]
    for name in ("parts", "dist", "e2e"):
        for ext in ("suf", "lcp", "llv", "prj", "esq"):
            assert (tmp_path / f"{name}.{ext}").read_bytes() == \
                (tmp_path / f"idx.{ext}").read_bytes(), (name, ext)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        for argv, text in zip(COMMANDS, got):
            if argv[0] == "suffixerator":
                continue
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(io.StringIO()):
                # readjoiner's, ltrdigest's and the annotation tools'
                # parsers take no --cpu
                ref_main([_ref_arg(a) for a in argv]
                         + ([] if argv[0] in ("readjoiner", "ltrdigest")
                            + HOST_TOOLS else ["--cpu"]))
            assert text == buf.getvalue(), argv
            assert text or argv[0] in QUIET or "-indexname" in argv or \
                "-tabout" in argv
    finally:
        os.chdir(cwd)
    for name, exts in WRITTEN.items():
        for ext in exts:
            assert (tmp_path / f"{name}.{ext}").read_bytes() == \
                (tmp_path / f"{name}_ref.{ext}").read_bytes(), (name, ext)
    for name in FILES:
        assert (tmp_path / name).read_bytes() == \
            (tmp_path / _ref_arg(name)).read_bytes(), name
    for name, exts in PREFIXED.items():
        for ext in exts:
            assert (tmp_path / f"{name}_{ext}").read_bytes() == \
                (tmp_path / f"{name}_ref_{ext}").read_bytes(), (name, ext)
    assert b"primer_binding_site" in \
        got[COMMANDS.index(["ltrdigest", "-trnas", "trna.fa", "-seqfile",
                            "ltr.fa", "-outfileprefix", "ld",
                            "lhs.gff3"])].encode()
    assert b"LTR_retrotransposon" in (tmp_path / "lh.gff3").read_bytes()
    assert b"contig_0" in (tmp_path / "rj.contigs.fas").read_bytes()
