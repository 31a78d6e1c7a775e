"""The GFF3 annotation layer of genometools_torch (anno/*, the converters,
the validator, extractfeat, the feature index and the stream tools)
against the reference package: every command of the port's CLI on the
same files as the reference's CLI (``genometools_tpu.cli.main``, in
process), with equal stdout, stderr, exit code (or raised exception and
its message), warnings and written files; and the modules the commands
stand on, function by function, on the same inputs.

The inputs are made here from numpy seeds (``make_annotation``): three
sequences of random ACGT with about 40 genes each, whose mRNAs carry
exon, CDS and UTR children; exons shared by two mRNAs (multi-parent),
``##sequence-region`` pragmas, comments and ``###`` separators, child
lines before their parents, attributes that need URL-escaping, Dbxref
attributes, and the same annotation with a ``##FASTA`` section and as
GTF and BED. The XRF abbreviation file, the OBO file, the chseqids
mapping, the filter scripts and the speck spec are written by the tests
too.
"""

import contextlib
import io
import os
import warnings
from pathlib import Path

import numpy as np
import pytest

_ACGT = np.array(list("acgt"))
SEQLEN = 60000


def _phases(cds, strand):
    """GFF3 phases of one mRNA's CDS segments, in transcript order."""
    order = cds if strand == "+" else cds[::-1]
    out, total = {}, 0
    for k, (s, e) in enumerate(order):
        out[(s, e)] = 0 if k == 0 else (3 - total % 3) % 3
        total += e - s + 1
    return [out[x] for x in cds]


def make_annotation(seed, nseq=3, genes=40, shuffle=True):
    """(GFF3 text, sequences {seqid: str}, gene models) of a random
    annotation made from numpy.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    seqs, models = {}, []
    for k in range(nseq):
        sid = f"chr{k + 1}"
        seqs[sid] = "".join(_ACGT[rng.integers(0, 4, SEQLEN)])
        for g in range(genes):
            lo = 300 + g * 1400 + int(rng.integers(0, 200))
            # 2-4 exons of 90-250 bp with 60-200 bp introns
            exons, p = [], lo
            for _ in range(int(rng.integers(2, 5))):
                n = int(rng.integers(90, 251))
                exons.append((p, p + n - 1))
                p += n + int(rng.integers(60, 201))
            models.append(dict(seqid=sid, gene=f"g{k}_{g}", exons=exons,
                               strand="+-"[int(rng.integers(0, 2))],
                               two=bool(rng.random() < 0.4 and
                                        len(exons) >= 3),
                               utr5=int(rng.integers(10, 60)),
                               utr3=int(rng.integers(10, 60)),
                               score=None if rng.random() < 0.5
                               else round(float(rng.random()), 3)))
    lines = ["##gff-version 3"]
    lines += [f"##sequence-region {s} 1 {SEQLEN}" for s in seqs]
    lines.append("# a generated annotation")
    for n, m in enumerate(models):
        block = _gene_lines(m, n)
        if shuffle and n % 3 == 1:
            block = block[1:] + block[:1]       # children before parent
        lines += block
        if n % 4 == 3:
            lines.append("###")
        if n % 7 == 0:
            lines.append(f"# after gene {m['gene']}")
    return "\n".join(lines) + "\n", seqs, models


def _gene_lines(m, n):
    sid, st, gid = m["seqid"], m["strand"], m["gene"]
    exons = m["exons"]
    lo, hi = exons[0][0], exons[-1][1]
    score = "." if m["score"] is None else str(m["score"])
    attrs = f"ID={gid};Name=gene%20{n}%3Bx"
    if n % 5 == 0:
        attrs += f";Dbxref=GO:{n:07d},SO:0000704"
    if n % 6 == 0:
        attrs += ";Note=a%2Cb%3Dc%25d"
    out = [f"{sid}\tgen\tgene\t{lo}\t{hi}\t{score}\t{st}\t.\t{attrs}"]
    mrnas = [(f"{gid}.t1", exons)]
    if m["two"]:
        mrnas.append((f"{gid}.t2", exons[:1] + exons[2:]))
    for tid, ex in mrnas:
        out.append(f"{sid}\tgen\tmRNA\t{ex[0][0]}\t{ex[-1][1]}\t.\t{st}\t.\t"
                   f"ID={tid};Parent={gid}")
    for e, (s, t) in enumerate(exons):
        parents = [tid for tid, ex in mrnas if (s, t) in ex]
        out.append(f"{sid}\tgen\texon\t{s}\t{t}\t.\t{st}\t.\t"
                   f"ID={gid}.e{e};Parent={','.join(parents)}")
    for tid, ex in mrnas:
        # the CDS leaves utr5/utr3 bp of the outer exons to the UTRs
        u5, u3 = (m["utr5"], m["utr3"]) if st == "+" \
            else (m["utr3"], m["utr5"])
        cds = [(s + (u5 if k == 0 else 0), t - (u3 if k == len(ex) - 1
                                                 else 0))
               for k, (s, t) in enumerate(ex)]
        for (s, t), ph in zip(cds, _phases(cds, st)):
            out.append(f"{sid}\tgen\tCDS\t{s}\t{t}\t.\t{st}\t{ph}\t"
                       f"ID={tid}.cds;Parent={tid}")
        left = "five_prime_UTR" if st == "+" else "three_prime_UTR"
        right = "three_prime_UTR" if st == "+" else "five_prime_UTR"
        out.append(f"{sid}\tgen\t{left}\t{ex[0][0]}\t{cds[0][0] - 1}\t.\t"
                   f"{st}\t.\tParent={tid}")
        out.append(f"{sid}\tgen\t{right}\t{cds[-1][1] + 1}\t{ex[-1][1]}\t.\t"
                   f"{st}\t.\tParent={tid}")
    return out


def gtf_of(models):
    """The annotation's GTF rendering: exon and CDS lines per mRNA."""
    out = []
    for m in models:
        sid, st, gid = m["seqid"], m["strand"], m["gene"]
        ex = m["exons"]
        for typ in ("exon", "CDS"):
            for k, (s, t) in enumerate(ex):
                if typ == "CDS":
                    s += m["utr5"] if k == 0 else 0
                    t -= m["utr3"] if k == len(ex) - 1 else 0
                out.append(f'{sid}\tgen\t{typ}\t{s}\t{t}\t.\t{st}\t'
                           f'{"0" if typ == "CDS" else "."}\t'
                           f'gene_id "{gid}"; transcript_id "{gid}.t1";')
    return "\n".join(out) + "\n"


def bed_of(models):
    """The annotation's BED12 rendering: one row per gene, the exons as
    blocks and the CDS as the thick range."""
    out = ['track name=genes offset=0', "# genes"]
    for m in models:
        ex = m["exons"]
        lo, hi = ex[0][0] - 1, ex[-1][1]
        sizes = ",".join(str(t - s + 1) for s, t in ex)
        starts = ",".join(str(s - 1 - lo) for s, _ in ex)
        out.append(f"{m['seqid']}\t{lo}\t{hi}\t{m['gene']}\t0\t{m['strand']}"
                   f"\t{lo + m['utr5']}\t{hi - m['utr3']}\t0\t{len(ex)}\t"
                   f"{sizes},\t{starts},")
    return "\n".join(out) + "\n"


def fasta_of(seqs, width=60):
    out = []
    for sid, s in seqs.items():
        out.append(f">{sid} generated")
        out += [s[i:i + width] for i in range(0, len(s), width)]
    return "\n".join(out) + "\n"


XRF = """! XRF abbreviations for the tests
abbreviation: GO
database: Gene Ontology
local_id_syntax: ^\\d{7}$

abbreviation: SO
shorthand_name: SeqOnt
synonym: so
local_id_syntax: ^\\d{7}$
"""
BAD_XRF = "abbreviation: GO\n\nabbreviation: GO\n"

OBO = "format-version: 1.2\n\n" + "".join(
    f"[Term]\nid: SO:{k:07d}\nname: {name}\n"
    + (f"is_a: SO:{k - 1:07d}\n" if k > 1 else "") + "\n"
    for k, name in enumerate(
        ["region", "gene", "mRNA", "exon", "CDS", "five_prime_UTR",
         "three_prime_UTR", "intron"], 1))

DROP_GENES = ('name = "drop"\nauthor = "a"\nversion = "1"\n'
              'email = "e@example.org"\nshort_descr = "drop long genes"\n'
              'description = "drops genes over 1,000 bp"\n'
              "def filter(gn):\n"
              '    return gn.type == "gene" and gn.range.length > 1000\n')
KEEP_PLUS = ('def name():\n    return "strand"\n'
             'author = "b"\nversion = "2"\nemail = "b@example.org"\n'
             'short_descr = "minus"\ndescription = "drops minus genes"\n'
             "def filter(gn):\n"
             '    return gn.type == "gene" and gn.strand == "-"\n')
SPEC = ('@feature("gene")\n'
        "def _(gene, it):\n"
        '    it("has a transcript", gene.has_child_of_supertype('
        '"transcript"))\n'
        '    it("children in range", gene.overlaps_all_children())\n'
        '    it("shorter than 1000", gene.range_length() < 1000)\n')


def _strict_errors():
    """(name, GFF3 text) of inputs the strict parser rejects."""
    head = "##gff-version 3\n##sequence-region c 1 1000\n"
    f = "c\tsrc\tgene\t{}\t{}\t.\t{}\t{}\t{}\n"
    return [
        ("eight_cols", head + "c\tsrc\tgene\t1\t10\t.\t+\t.\n"),
        ("start_gt_end", head + f.format(20, 10, "+", ".", "ID=a")),
        ("bad_strand", head + f.format(1, 10, "x", ".", "ID=a")),
        ("bad_phase", head + f.format(1, 10, "+", "3", "ID=a")),
        ("no_equals", head + f.format(1, 10, "+", ".", "ID")),
        ("dup_attr", head + f.format(1, 10, "+", ".", "ID=a;ID=b")),
        ("undef_parent", head + f.format(1, 10, "+", ".", "Parent=zz")),
        ("outside_region", head + f.format(900, 1100, "+", ".", "ID=a")),
        ("bad_version", "##gff-version 2\n" + f.format(1, 10, "+", ".",
                                                        "ID=a")),
        ("bad_region", "##gff-version 3\n##sequence-region c 1\n"),
        ("non_numeric", head + f.format("x", 10, "+", ".", "ID=a")),
        ("cds_phase", head + f.format(1, 100, "+", ".", "ID=m")
         + "c\tsrc\tCDS\t1\t10\t.\t+\t0\tParent=m\n"
         + "c\tsrc\tCDS\t20\t30\t.\t+\t0\tParent=m\n"),
    ]


def write_inputs(d: Path) -> None:
    text, seqs, models = make_annotation(7)
    (d / "a.gff3").write_text(text)
    (d / "genome.fa").write_text(fasta_of(seqs))
    (d / "fa.gff3").write_text(text + "##FASTA\n" + fasta_of(seqs, 70))
    (d / "a.gtf").write_text(gtf_of(models))
    (d / "a.bed").write_text(bed_of(models))
    btext, _, _ = make_annotation(8, nseq=2, genes=12, shuffle=False)
    (d / "b.gff3").write_text(btext)
    # one sequence: csa's sortedness test compares ranges across seqids
    one, _, _ = make_annotation(10, nseq=1, genes=30, shuffle=False)
    (d / "one.gff3").write_text(one)
    (d / "xrf.abbr").write_text(XRF)
    (d / "bad.abbr").write_text(BAD_XRF)
    (d / "so.obo").write_text(OBO)
    (d / "map.lua").write_text(
        'chseqids = {\n  chr1 = "alpha",\n  ["chr2"] = "beta",\n'
        '  chr3 = "alpha",\n}\n')
    (d / "partial.lua").write_text('chseqids = { chr1 = "alpha" }\n')
    (d / "drop.py").write_text(DROP_GENES)
    (d / "minus.py").write_text(KEEP_PLUS)
    (d / "spec.py").write_text(SPEC)
    lines = text.splitlines()
    # a wrong CDS phase (-tidy corrects it), a bad Dbxref, a type the
    # OBO file lacks, a child outside its parent
    k = next(i for i, x in enumerate(lines) if "\tCDS\t" in x and
             x.split("\t")[7] != "0")
    bad = lines[:k] + ["\t".join(lines[k].split("\t")[:7] + ["0"] +
                                 lines[k].split("\t")[8:])] + lines[k + 1:]
    (d / "badphase.gff3").write_text("\n".join(bad) + "\n")
    (d / "badxrf.gff3").write_text(text.replace("Dbxref=GO:0000005",
                                                "Dbxref=GO:12x"))
    (d / "badtype.gff3").write_text(text.replace("\tmRNA\t", "\ttranscriptx\t",
                                                 1))
    (d / "loc.gff3").write_text(
        "##gff-version 3\nc\tsrc\tgene\t100\t200\t.\t+\t.\tID=g\n"
        "c\tsrc\texon\t90\t150\t.\t+\t.\tParent=g\n"
        "c\tsrc\texon\t180\t250\t.\t+\t.\tParent=g\n")
    for name, body in _strict_errors():
        (d / f"err_{name}.gff3").write_text(body)


# each case: the argv lists run one after the other in one directory
CASES = {
    "gff3": [["gff3", "a.gff3"]],
    "gff3_sort": [["gff3", "-sort", "a.gff3"]],
    "gff3_sort_retainids": [["gff3", "-sort", "-retainids", "a.gff3"]],
    "gff3_addintrons": [["gff3", "-addintrons", "-sort", "a.gff3"]],
    "gff3_two_files": [["gff3", "-sort", "a.gff3", "b.gff3"]],
    "gff3_fasta": [["gff3", "fa.gff3"]],
    "gff3_tidy": [["gff3", "-tidy", "badphase.gff3"]],
    "gff3_strict_phase": [["gff3", "badphase.gff3"]],
    "gff3_xrfcheck": [["gff3", "-xrfcheck", "xrf.abbr", "a.gff3"]],
    "gff3_xrfcheck_bad_xref": [["gff3", "-xrfcheck", "xrf.abbr",
                                "badxrf.gff3"]],
    "gff3_xrfcheck_bad_file": [["gff3", "-xrfcheck", "bad.abbr",
                                "a.gff3"]],
    "gff3_xrfcheck_missing": [["gff3", "-xrfcheck", "NOSUCHDB",
                               "a.gff3"]],
    "stat": [["stat", "a.gff3"]],
    "stat_two": [["stat", "a.gff3", "b.gff3"]],
    "gtf_to_gff3": [["gtf_to_gff3", "a.gtf"]],
    "bed_to_gff3": [["bed_to_gff3", "a.bed"]],
    "gff3_to_gtf": [["gff3_to_gtf", "a.gff3"]],
    "select_seqid": [["select", "-seqid", "chr2", "a.gff3"]],
    "select_type": [["select", "-hastype", "mRNA", "a.gff3"]],
    "select_length": [["select", "-maxgenelength", "900", "a.gff3"]],
    "select_contain": [["select", "-contain", "1000", "20000", "a.gff3"]],
    "select_rules": [["select", "a.gff3", "-rule_files", "drop.py"]],
    "select_rules_or": [["select", "a.gff3", "-rule_files", "drop.py",
                         "minus.py", "-rule_logic", "OR"]],
    "select_rules_and": [["select", "a.gff3", "-rule_files", "drop.py",
                          "minus.py"]],
    "chseqids": [["chseqids", "map.lua", "a.gff3"]],
    "chseqids_sort_o": [["chseqids", "-sort", "-o", "ch.gff3", "map.lua",
                         "a.gff3"]],
    "chseqids_missing": [["chseqids", "partial.lua", "a.gff3"]],
    "chseqids_undefined": [["chseqids", "drop.py", "a.gff3"]],
    "dupfeat": [["dupfeat", "-dest", "exon", "-source", "CDS", "a.gff3"]],
    "mergefeat": [["mergefeat", "a.gff3"]],
    "id_to_md5": [["id_to_md5", "-seqfile", "genome.fa", "-matchdesc",
                   "a.gff3"]],
    "id_to_md5_no_seqfile": [["id_to_md5", "a.gff3"]],
    "md5_roundtrip": [["id_to_md5", "-seqfiles", "genome.fa", "-matchdesc",
                       "a.gff3"],
                      ["md5_to_id", "-seqfile", "genome.fa", "-matchdesc",
                       "md5.gff3"]],
    "scriptfilter": [["scriptfilter", "drop.py", "minus.py"]],
    "scriptfilter_oneline": [["scriptfilter", "-oneline", "-scriptname",
                              "false", "drop.py"]],
    "seqids": [["seqids", "a.gff3"]],
    "seqids_missing": [["seqids", "nosuch.gff3"]],
    "loccheck": [["loccheck", "loc.gff3"]],
    "gff3validator": [["gff3validator", "a.gff3"]],
    "gff3validator_typecheck": [["gff3validator", "-typecheck", "so.obo",
                                 "a.gff3"]],
    "gff3validator_bad_type": [["gff3validator", "-typecheck", "so.obo",
                                "badtype.gff3"]],
    "gff3validator_bad_phase": [["gff3validator", "badphase.gff3"]],
    "inlineseq_split": [["inlineseq_split", "fa.gff3", "-seqfile",
                         "split.fa", "-gff3file", "split.gff3"]],
    "inlineseq_add": [["inlineseq_add", "a.gff3", "-seqfile", "genome.fa",
                       "-matchdesc"]],
    "merge": [["gff3", "-sort", "a.gff3"], ["merge", "sorted.gff3",
                                            "b.gff3"]],
    "uniq": [["uniq", "a.gff3", "a.gff3"]],
    "interfeat": [["interfeat", "a.gff3"]],
    "interfeat_cds": [["interfeat", "-outside", "CDS", "-inter", "gap",
                       "a.gff3"]],
    "extractfeat": [["extractfeat", "a.gff3", "-seqfile", "genome.fa"]],
    "extractfeat_join": [["extractfeat", "a.gff3", "-seqfile", "genome.fa",
                          "-type", "CDS", "-join"]],
    "extractfeat_translate": [["extractfeat", "a.gff3", "-seqfile",
                               "genome.fa", "-type", "CDS", "-join",
                               "-translate"]],
    "extractfeat_gene": [["extractfeat", "a.gff3", "-seqfile", "genome.fa",
                          "-type", "gene"]],
    "featureindex": [["mkfeatureindex", "-filename", "fi.db", "a.gff3",
                      "b.gff3"],
                     ["featureindex", "-filename", "fi.db"],
                     ["featureindex", "-filename", "fi.db", "-seqid",
                      "chr2", "-range", "1000", "20000"]],
    "speck": [["speck", "-specfile", "spec.py", "a.gff3"]],
    "speck_failhard": [["speck", "-specfile", "spec.py", "-failhard",
                        "a.gff3"]],
    "csa": [["csa", "one.gff3"]],
    "csa_join": [["csa", "-join-length", "1000", "one.gff3"]],
    "csa_unsorted": [["csa", "-join-length", "100", "a.gff3"]],
    "eval": [["gff3", "-sort", "a.gff3"], ["gff3", "-sort", "b.gff3"],
             ["eval", "sorted.gff3", "sorted2.gff3"]],
    "eval_self": [["gff3", "-sort", "a.gff3"],
                  ["eval", "-nuc", "no", "sorted.gff3", "sorted.gff3"]],
    "cds": [["gff3", "-sort", "a.gff3"],
            ["cds", "-seqfile", "genome.fa", "-matchdesc", "-minorflen",
             "30", "-startcodon", "yes", "sorted.gff3"]],
    "splicesiteinfo": [["splicesiteinfo", "-seqfile", "genome.fa",
                        "-matchdesc", "-addintrons", "a.gff3"]],
    "splicesiteinfo_no_introns": [["splicesiteinfo", "-seqfile",
                                   "genome.fa", "-matchdesc", "a.gff3"]],
    "orffinder": [["gff3", "-sort", "a.gff3"],
                  ["orffinder", "-seqfile", "genome.fa", "-matchdesc",
                   "-types", "mRNA", "-min", "60", "sorted.gff3"]],
    "orffinder_bad_min": [["orffinder", "-seqfile", "genome.fa", "-min",
                           "20", "a.gff3"]],
    "regioncov": [["gff3", "-sort", "a.gff3"],
                  ["regioncov", "-maxfeaturedist", "100", "sorted.gff3"]],
    "snpper": [["snpper", "a.gff3", "snps.gvf", "-seqfile", "genome.fa",
                "-matchdesc"]],
    "snpper_no_seqfile": [["snpper", "a.gff3", "snps.gvf"]],
    "snpper_bad_table": [["snpper", "-trans_table", "99", "a.gff3",
                          "snps.gvf", "-seqfile", "genome.fa"]],
}
for _name, _ in _strict_errors():
    CASES[f"strict_{_name}"] = [["gff3", f"err_{_name}.gff3"],
                                ["gff3validator", f"err_{_name}.gff3"]]


def _snps(d: Path) -> None:
    """A GVF of SNVs inside the genes' CDS (numpy seed 9)."""
    rng = np.random.default_rng(9)
    _, seqs, models = make_annotation(7)
    lines = ["##gff-version 3", "##gvf-version 1.10"]
    for m in sorted(models, key=lambda m: (m["seqid"], m["exons"][0][0])):
        s, t = m["exons"][1]
        for p in sorted(rng.choice(np.arange(s, t + 1), 2, replace=False)):
            ref = seqs[m["seqid"]][p - 1].upper()
            alt = "ACGT"[int(rng.integers(0, 4))]
            lines.append(f"{m['seqid']}\tgen\tSNV\t{p}\t{p}\t.\t+\t.\t"
                         f"ID=snp{p};Reference_seq={ref};"
                         f"Variant_seq={alt},{ref}")
    (d / "snps.gvf").write_text("\n".join(lines) + "\n")


def _run(main, argv, cwd: Path):
    """(exit code or raised exception, stdout, stderr, warnings)."""
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                rc = main(argv)
            except SystemExit as e:
                rc = ("exit", e.code)
            except Exception as e:     # the same exception, both sides
                rc = ("raised", type(e).__name__, str(e))
    finally:
        os.chdir(old)
    return rc, out.getvalue(), err.getvalue(), \
        [str(w.message) for w in caught]


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.suffix != ".db"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_reference(case, tmp_path):
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    dirs = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        write_inputs(d)
        _snps(d)
        dirs[side] = d
    for argv in CASES[case]:
        got = []
        for side, fn in (("ref", ref_main), ("port", main)):
            got.append(_run(fn, argv, dirs[side]))
            if argv[:2] == ["gff3", "-sort"]:
                # the next steps read the sorted annotation
                name = "sorted2.gff3" if argv[-1] == "b.gff3" \
                    else "sorted.gff3"
                (dirs[side] / name).write_text(got[-1][1])
            if argv[0] == "id_to_md5":
                (dirs[side] / "md5.gff3").write_text(got[-1][1])
        assert got[1] == got[0], argv
    assert _files(dirs["port"]) == _files(dirs["ref"])
    rc, out, err = got[0][:3]
    # every case prints or writes something
    assert out or err or rc not in (0, None) or \
        "-o" in CASES[case][-1] or "-gff3file" in CASES[case][-1], case


def test_generated_annotation_is_what_it_says(tmp_path):
    """The generator's input has what the cases rely on: every gene
    parses with its mRNAs, multi-parent exons, UTRs, CDS phases the
    strict parser accepts, escaped attributes and Dbxrefs."""
    from genometools_torch.anno.genome_node import FeatureNode
    from genometools_torch.anno.gff3 import parse_gff3
    text, seqs, models = make_annotation(7)
    nodes = parse_gff3(text)
    genes = [n for n in nodes if isinstance(n, FeatureNode)]
    assert len(genes) == len(models) == 120 and len(seqs) == 3
    multi = [c for g in genes for c in g.traverse()
             if c.type == "exon" and len(c.parents) > 1]
    assert multi
    types = {c.type for g in genes for c in g.traverse()}
    assert types == {"gene", "mRNA", "exon", "CDS", "five_prime_UTR",
                     "three_prime_UTR"}
    assert any(";" in g.get_attribute("Name") for g in genes)
    assert any(g.get_attribute("Dbxref") for g in genes)
    assert "###" in text and "\n# " in text


# ---------------------------------------------------------------------------
# the modules, function by function
# ---------------------------------------------------------------------------

def _pair(mod):
    import importlib
    return (importlib.import_module(f"genometools_tpu.{mod}"),
            importlib.import_module(f"genometools_torch.{mod}"))


def _render(gff3_mod, nodes, **kw):
    return gff3_mod.GFF3Writer(**kw).render(list(nodes))


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("seed", [1, 2])
def test_parse_and_write_gff3(seed, strict):
    rg, tg = _pair("anno.gff3")
    text, _, _ = make_annotation(seed)
    for retainids in (False, True):
        assert _render(tg, tg.parse_gff3(text, strict=strict),
                       retainids=retainids) == \
            _render(rg, rg.parse_gff3(text, strict=strict),
                    retainids=retainids)


@pytest.mark.parametrize("name", [n for n, _ in _strict_errors()])
def test_strict_errors(name):
    rg, tg = _pair("anno.gff3")
    body = dict(_strict_errors())[name]
    with pytest.raises(rg.GFF3Error) as r:
        rg.parse_gff3(body)
    with pytest.raises(tg.GFF3Error) as t:
        tg.parse_gff3(body)
    assert str(t.value) == str(r.value)


STREAMS = {
    "sort": lambda ns, n: ns.sort_stream(n),
    "addintrons": lambda ns, n: ns.add_introns_stream(n),
    "uniq": lambda ns, n: ns.uniq_stream(ns.sort_stream(n + n)),
    "interfeat": lambda ns, n: ns.inter_feature_stream(n, "exon", "intron"),
    "dupfeat": lambda ns, n: ns.dupfeat_stream(n, "exon", "CDS"),
    "mergefeat": lambda ns, n: ns.mergefeat_stream(n),
    "chseqids": lambda ns, n: ns.chseqids_stream(
        n, {"chr1": "x", "chr2": "x", "chr3": "y"}),
    "select": lambda ns, n: ns.select_stream(n, seqid="chr3",
                                             max_gene_length=1000),
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_node_streams(stream):
    rg, tg = _pair("anno.gff3")
    rn, tn = _pair("anno.node_stream")
    text, _, _ = make_annotation(3)
    assert _render(tg, STREAMS[stream](tn, tg.parse_gff3(text))) == \
        _render(rg, STREAMS[stream](rn, rg.parse_gff3(text)))


def test_stat_stream_and_merge():
    rg, tg = _pair("anno.gff3")
    rn, tn = _pair("anno.node_stream")
    a, _, _ = make_annotation(4, shuffle=False)
    b, _, _ = make_annotation(5, nseq=2, shuffle=False)
    out = []
    for g, n in ((rg, rn), (tg, tn)):
        st = n.FeatureStats()
        merged = list(n.merge_stream([n.sort_stream(g.parse_gff3(a)),
                                      n.sort_stream(g.parse_gff3(b))]))
        list(n.stat_stream(merged, st))
        out.append((st.counts, _render(g, merged)))
    assert out[1] == out[0]


def test_parsers_roundtrip():
    rg, tg = _pair("anno.gff3")
    rp, tp = _pair("anno.parsers")
    text, _, models = make_annotation(6)
    assert tp.gff3_to_gtf(tg.parse_gff3(text)) == \
        rp.gff3_to_gtf(rg.parse_gff3(text))
    for parse, src in (("parse_gtf", gtf_of(models)),
                       ("parse_bed", bed_of(models))):
        assert _render(tg, getattr(tp, parse)(src), retainids=True) == \
            _render(rg, getattr(rp, parse)(src), retainids=True)


def test_md5_translation(tmp_path):
    rg, tg = _pair("anno.gff3")
    rm, tm = _pair("anno.md5translate")
    text, seqs, _ = make_annotation(2)
    (tmp_path / "g.fa").write_text(fasta_of(seqs))
    got = []
    for g, m in ((rg, rm), (tg, tm)):
        col = m.SeqCollection([str(tmp_path / "g.fa")], matchdesc=True)
        md5 = _render(g, m.id_to_md5_nodes(iter(g.parse_gff3(text)), col),
                      retainids=True)
        back = _render(g, m.md5_to_id_nodes(iter(g.parse_gff3(md5)), col),
                       retainids=True)
        got.append((md5, back))
    assert got[1] == got[0]
    assert "md5:" in got[0][0]


def test_xrf_checker(tmp_path):
    rx, tx = _pair("anno.xrf")
    ok = ["GO:0000001", "so:0000704", "GO:0000001,SO:0000002"]
    bad = ["GO0000001", "GO:", "XX:1", "GO:12x"]
    for mod in (rx, tx):
        assert [e.values for e in mod.parse_xrf_abbr(XRF)] == \
            [e.values for e in rx.parse_xrf_abbr(XRF)]
    rc, tc = rx.XRFChecker(rx.parse_xrf_abbr(XRF)), \
        tx.XRFChecker(tx.parse_xrf_abbr(XRF))
    for v in ok:
        rc.check(v)
        tc.check(v)
    for v in bad:
        with pytest.raises(rx.XRFError) as r:
            rc.check(v)
        with pytest.raises(tx.XRFError) as t:
            tc.check(v)
        assert str(t.value) == str(r.value)
    for text in (BAD_XRF, "abbreviation GO\n", "database: x\n",
                 "abbreviation: A\nshorthand_name: abcdefghijk\n",
                 "abbreviation: A\nlocal_id_syntax: ([\n"):
        with pytest.raises(rx.XRFError) as r:
            rx.parse_xrf_abbr(text, "f")
        with pytest.raises(tx.XRFError) as t:
            tx.parse_xrf_abbr(text, "f")
        assert str(t.value) == str(r.value)
    # an explicit file resolves to itself; an abbreviation name through
    # $GT_DATA_PATH's xrf_abbr/ directory
    (tmp_path / "xrf_abbr").mkdir()
    (tmp_path / "xrf_abbr" / "GO.xrf_abbr").write_text(XRF)
    os.environ["GT_DATA_PATH"] = str(tmp_path)
    try:
        for mod in (rx, tx):
            assert mod.resolve_xrf_path("GO") == \
                str(tmp_path / "xrf_abbr" / "GO.xrf_abbr")
            assert mod.resolve_xrf_path(None) == \
                str(tmp_path / "xrf_abbr" / "GO.xrf_abbr")
    finally:
        del os.environ["GT_DATA_PATH"]


def test_type_checker_and_anno_db(tmp_path):
    ra, ta = _pair("anno.anno_db")
    rg, tg = _pair("anno.gff3")
    text, _, _ = make_annotation(5)
    r, t = ra.TypeChecker.from_obo(OBO), ta.TypeChecker.from_obo(OBO)
    for a in ("CDS", "exon", "gene", "nope"):
        for b in ("region", "gene", "CDS"):
            assert t.is_a(a, b) == r.is_a(a, b)
    bad = text.replace("\tmRNA\t", "\tnope\t")
    assert t.check_nodes(tg.parse_gff3(bad)) == \
        r.check_nodes(rg.parse_gff3(bad)) != []
    out = []
    for mod, g in ((ra, rg), (ta, tg)):
        db = mod.AnnoDB(str(tmp_path / f"{mod.__name__}.db"))
        db.add_gff3(g.parse_gff3(text))
        db.conn.commit()
        out.append((db.seqids(), _render(g, db.features_for_range(
            "chr2", 5000, 30000), retainids=True)))
    assert out[1] == out[0]
    # the BAM branch: the same records as the reference's
    from test_torch_hop import make_mapping, write_bam
    refs, recs, _ = make_mapping(3)
    write_bam(tmp_path / "x.bam", refs, recs)
    rows = [[(a.qname, a.flag, a.rname, a.pos, a.mapq, a.cigar, a.seq)
             for a in mod.parse_bam(str(tmp_path / "x.bam"))]
            for mod in (ra, ta)]
    assert rows[1] == rows[0] and len(rows[1]) == len(recs)


def test_feature_index_and_extract():
    rg, tg = _pair("anno.gff3")
    rf, tf = _pair("anno.feature_index")
    text, seqs, _ = make_annotation(4)
    for kw in (dict(), dict(join=True), dict(join=True, translate=True)):
        for typ in ("exon", "CDS", "mRNA"):
            r = rf.extract_features(rg.parse_gff3(text), seqs, typ, **kw)
            t = tf.extract_features(tg.parse_gff3(text), seqs, typ, **kw)
            assert t.descs == r.descs
            assert [x.tobytes() for x in t.seqs] == \
                [x.tobytes() for x in r.seqs]


def test_seqtools_and_trans_table():
    rs, ts = _pair("utils.seqtools")
    rt, tt = _pair("core.trans_table")
    rng = np.random.default_rng(11)
    for n in (0, 1, 2, 3, 50, 301):
        s = "".join(rng.choice(list("acgtnACGTN"), n))
        assert ts.revcomp_str(s) == rs.revcomp_str(s)
        for frame in range(3):
            assert ts.translate_dna(s, frame) == rs.translate_dna(s, frame)
    for table in (1, 2, 11):
        r, t = rt.TransTable(table), tt.TransTable(table)
        for c in ("atg", "taa", "tga", "agg", "ttt"):
            assert (t.is_stop_codon(*c), t.translate(*c)) == \
                (r.is_stop_codon(*c), r.translate(*c))


def test_alignment_module():
    ra, ta = _pair("match.alignment")
    rng = np.random.default_rng(12)
    for _ in range(4):
        u = rng.integers(0, 5, int(rng.integers(5, 30))).astype(np.uint8)
        v = rng.integers(0, 5, int(rng.integers(5, 30))).astype(np.uint8)
        for fn, kw in (("local_alignment", dict(matchscore=5,
                                                mismatchscore=-10,
                                                gapscore=-20)),
                       ("local_alignment", dict()),
                       ("global_alignment", dict()),
                       ("global_alignment_affine", dict())):
            r = getattr(ra, fn)(u, v, **kw)
            t = getattr(ta, fn)(u, v, **kw)
            assert vars(t) == vars(r)
            assert t.cigar(True, u, v) == r.cigar(True, u, v)
        assert ta.edit_distance(u, v) == ra.edit_distance(u, v)
