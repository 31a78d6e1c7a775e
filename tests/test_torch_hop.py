"""hop and sambam of the port against the reference's, and the BAM branch
of ``anno/anno_db.py::parse_bam``.

The tests write their own inputs: a cognate sequence with planted
homopolymers, reads drawn from it with homopolymer-length errors on both
strands (numpy seeds), their mapping as SAM text, and the same records as
BAM: BGZF blocks (gzip members with the BC extra field, then the empty
end-of-file block) holding the BAM header and records, written with gzip,
zlib and struct (``write_bam``).
"""

import re
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from test_torch_anno import _run

_ACGT = "acgt"
_CIGAR_OPS = "MIDNSHP=X"
_SEQ_CODES = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


def _revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("acgtACGT", "tgcaTGCA"))


def make_mapping(seed: int, nreads: int = 60):
    """(cognate [(desc, seq)], SAM records, FASTQ text) from numpy seed:
    two cognate sequences with planted homopolymers of 3-7; reads of
    80-150 bp with one homopolymer one longer or shorter (an I or a D in
    the CIGAR), some soft-clipped, some reverse (flag 16: the SAM holds
    the forward strand, the FASTQ the read), one secondary and one
    unmapped record."""
    rng = np.random.default_rng(seed)
    refs = []
    for k in range(2):
        parts = []
        while sum(map(len, parts)) < 2500:
            parts.append("".join(_ACGT[i] for i in rng.integers(0, 4, int(
                rng.integers(10, 40)))))
            parts.append(_ACGT[int(rng.integers(0, 4))] *
                         int(rng.integers(3, 8)))
        refs.append((f"chr{k + 1} cognate {k + 1}", "".join(parts)))
    recs, fastq = [], []
    for r in range(nreads):
        k = int(rng.integers(0, 2))
        ref = refs[k][1]
        n = int(rng.integers(80, 151))
        pos = int(rng.integers(0, len(ref) - n))
        seq = ref[pos:pos + n]
        cigar = [(n, "M")]
        runs = [i for i in range(5, n - 10) if seq[i] == seq[i - 1] ==
                seq[i - 2] and seq[i] != seq[i + 1]]
        kind = int(rng.integers(0, 3))
        if runs and kind:
            i = runs[int(rng.integers(0, len(runs)))]
            if kind == 1:                       # one base too many
                seq = seq[:i + 1] + seq[i] + seq[i + 1:]
                cigar = [(i + 1, "M"), (1, "I"), (n - i - 1, "M")]
            else:                               # one base too few
                seq = seq[:i] + seq[i + 1:]
                cigar = [(i, "M"), (1, "D"), (n - i - 1, "M")]
        if r % 7 == 3:                          # a soft clip in front
            clip = "".join(_ACGT[i] for i in rng.integers(0, 4, 4))
            seq = clip + seq
            cigar = [(4, "S")] + cigar
            pos += 4 if pos + 4 < len(ref) else 0
        qual = "".join(chr(33 + int(q)) for q in
                       rng.integers(10, 41, len(seq)))
        flag = 16 if r % 3 == 1 else 0
        if r == nreads - 2:
            flag |= 256
        mapq = int(rng.choice([5, 15, 30, 60]))
        name = f"read{r}"
        cig = "".join(f"{c}{op}" for c, op in cigar)
        recs.append((name, flag, f"chr{k + 1}", pos + 1, mapq, cig,
                     seq.upper(), qual))
        if not flag & 256:
            rd, rq = (_revcomp(seq), qual[::-1]) if flag & 16 else (seq,
                                                                    qual)
            fastq.append(f"@{name} extra\n{rd.upper()}\n+\n{rq}\n")
    seq = "".join(_ACGT[i] for i in rng.integers(0, 4, 90)).upper()
    qual = "I" * 90
    recs.append(("unmapped0", 4, "*", 0, 0, "*", seq, qual))
    fastq.append(f"@unmapped0\n{seq}\n+\n{qual}\n")
    fastq.append("@notinmapping\nACGT\n+\nIIII\n")
    return refs, recs, "".join(fastq)


def sam_text(refs, recs, header=True) -> str:
    lines = ["@HD\tVN:1.6\tSO:coordinate"] + \
        [f"@SQ\tSN:{d.split()[0]}\tLN:{len(s)}" for d, s in refs] \
        if header else []
    order = sorted(recs, key=lambda r: (r[2] == "*", r[2], r[3]))
    for name, flag, rname, pos, mapq, cig, seq, qual in order:
        lines.append(f"{name}\t{flag}\t{rname}\t{pos}\t{mapq}\t{cig}\t*\t0"
                     f"\t0\t{seq}\t{qual}")
    return "\n".join(lines) + "\n"


def _bgzf_block(data: bytes) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    body = c.compress(data) + c.flush()
    header = struct.pack("<4BI2BH2BH", 31, 139, 8, 4, 0, 0, 255, 6,
                         ord("B"), ord("C"), 2)
    bsize = len(header) + 2 + len(body) + 8
    return header + struct.pack("<H", bsize - 1) + body + \
        struct.pack("<II", zlib.crc32(data), len(data))


def write_bam(path: Path, refs, recs, block: int = 600) -> None:
    """A BAM file of the records (in SAM order), as BGZF blocks of at
    most `block` uncompressed bytes."""
    text = sam_text(refs, [], header=True).encode()
    raw = b"BAM\x01" + struct.pack("<i", len(text)) + text + \
        struct.pack("<i", len(refs))
    ids = {}
    for i, (d, s) in enumerate(refs):
        name = d.split()[0].encode() + b"\x00"
        ids[d.split()[0]] = i
        raw += struct.pack("<i", len(name)) + name + struct.pack("<i", len(s))
    order = sorted(recs, key=lambda r: (r[2] == "*", r[2], r[3]))
    for name, flag, rname, pos, mapq, cig, seq, qual in order:
        ops = [] if cig == "*" else [
            (int(n), op) for n, op in
            re.findall(r"(\d+)([MIDNSHP=X])", cig)]
        nm = name.encode() + b"\x00"
        packed = bytearray((len(seq) + 1) // 2)
        for i, ch in enumerate(seq):
            packed[i >> 1] |= _SEQ_CODES[ch] << (4 if i % 2 == 0 else 0)
        body = struct.pack("<iiBBHHHiiii", ids.get(rname, -1), pos - 1,
                           len(nm), mapq, 4680, len(ops), flag, len(seq),
                           -1, -1, 0) + nm + \
            b"".join(struct.pack("<I", n << 4 | _CIGAR_OPS.index(op))
                     for n, op in ops) + bytes(packed) + \
            bytes(ord(q) - 33 for q in qual)
        raw += struct.pack("<i", len(body)) + body
    out = b"".join(_bgzf_block(raw[i:i + block])
                   for i in range(0, len(raw), block))
    path.write_bytes(out + _bgzf_block(b""))


def write_inputs(d: Path, seed: int) -> None:
    refs, recs, fq = make_mapping(seed)
    (d / "cog.fa").write_text("".join(f">{desc}\n{s}\n" for desc, s in refs))
    (d / "map.sam").write_text(sam_text(refs, recs))
    (d / "nohdr.sam").write_text(sam_text(refs, recs, header=False))
    write_bam(d / "map.bam", refs, recs)
    (d / "reads.fq").write_text(fq)
    (d / "more.fastq").write_text(fq.split("@read5 ", 1)[0])


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


HOP = {
    "aggressive_sam": ["-aggressive", "-sam", "-map", "map.sam"],
    "aggressive_bam": ["-aggressive", "-map", "map.bam"],
    "moderate": ["-moderate", "-map", "map.bam"],
    "conservative": ["-conservative", "-map", "map.sam"],
    "expert": ["-expert", "-hmin", "4", "-read-hmin", "1", "-mapqmin", "10",
               "-altmax", "1.0", "-cogmin", "0.0", "-map", "map.bam"],
    "expert_partial": ["-expert", "-allow-partial", "-allow-multiple",
                       "-clenmax", "2", "-qmax", "60", "-covmin", "2",
                       "-map", "map.sam"],
    "encseq_cognate": ["-aggressive", "-map", "map.sam", "-c", "cog"],
    "no_mode": ["-map", "map.sam"],
}


@pytest.mark.parametrize("seed", [1, 5])
@pytest.mark.parametrize("case", sorted(HOP))
def test_hop_matches_reference(case, seed, tmp_path):
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    got = []
    for side, fn in (("ref", ref_main), ("port", main)):
        d = tmp_path / side
        d.mkdir()
        write_inputs(d, seed)
        argv = HOP[case]
        if "-c" in argv:
            assert _run(fn, ["encseq", "encode", "cog.fa", "-indexname",
                             "cog"], d)[0] == 0
        else:
            argv = argv + ["-c", "cog.fa"]
        got.append(_run(fn, ["hop"] + argv + ["-reads", "reads.fq",
                                               "more.fastq"], d))
    assert got[1] == got[0]
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    rc, out, err, warns = got[0]
    if case == "no_mode":
        assert rc == 1 and "Select correction mode" in err
    else:
        assert rc == 0 and "ID not found: notinmapping" in warns
        hop = (tmp_path / "port" / "hop_reads.fq").read_text()
        # every read of reads.fq but the one not in the mapping
        assert len(hop.splitlines()) == 4 * 60


def test_hop_corrects_planted_errors():
    """Under -aggressive the homopolymer errors of forward, primary reads
    without a soft clip come back as the cognate's slice."""
    from genometools_torch.assembly.hop import (HopParams,
                                                alignments_from_sam,
                                                hop_correct)
    refs, recs, _ = make_mapping(1)
    res = hop_correct([(d, s) for d, s in refs],
                      alignments_from_sam(sam_text(refs, recs)),
                      HopParams.aggressive())
    seqs = dict((d.split()[0], s) for d, s in refs)
    fixed = 0
    for name, flag, rname, pos, mapq, cig, seq, qual in recs:
        if flag or "S" in cig or ("I" not in cig and "D" not in cig):
            continue
        ref_len = sum(int(n) for n, op in re.findall(
            r"(\d+)([MD])", cig))
        got, _ = res[name].output()
        fixed += got == seqs[rname][pos - 1:pos - 1 + ref_len]
    assert fixed >= 5


@pytest.mark.parametrize("seed", [1, 5])
@pytest.mark.parametrize("argv", [["map.sam", "-sam"], ["map.bam"],
                                  ["nohdr.sam", "-sam"],
                                  ["nohdr.sam", "-sam", "-idxfile", "x"]],
                         ids=["sam", "bam", "sam_no_header",
                              "sam_idxfile"])
def test_sambam_matches_reference(argv, seed, tmp_path):
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    write_inputs(tmp_path, seed)
    ref = _run(ref_main, ["sambam"] + argv, tmp_path)
    got = _run(main, ["sambam"] + argv, tmp_path)
    assert got == ref
    if argv == ["nohdr.sam", "-sam"]:
        assert ref[0] == 1 and "no header" in ref[2]
    else:
        assert ref[0] == 0 and ref[1].count("\n") == 61


@pytest.mark.parametrize("seed", [1, 5])
def test_bam_reader_and_parse_bam(seed, tmp_path):
    """alignments_from_bam reads back what write_bam wrote, equal to the
    SAM records in both packages; anno_db.parse_bam's records equal the
    reference's field by field."""
    from genometools_tpu.anno import anno_db as rdb
    from genometools_tpu.assembly import hop as rhop

    from genometools_torch.anno import anno_db as tdb
    from genometools_torch.assembly import hop as thop
    write_inputs(tmp_path, seed)
    bam, sam = str(tmp_path / "map.bam"), (tmp_path / "map.sam").read_text()
    for mod in (rhop, thop):
        assert mod.alignments_from_bam(bam) == mod.alignments_from_sam(sam)
    assert len(thop.alignments_from_bam(bam)) == 61
    fields = ("qname", "flag", "rname", "pos", "mapq", "cigar", "seq")

    def row(a):
        return tuple(getattr(a, f) for f in fields) + (
            a.reference_length if a.cigar != "*" else None,)
    rows = [[row(a) for a in mod.parse_bam(bam)] for mod in (rdb, tdb)]
    assert rows[1] == rows[0]
    assert rows[1] == [row(a) for a in tdb.parse_sam(sam)]
