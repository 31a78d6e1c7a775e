"""Sequence input: FASTA / FASTQ / EMBL / GenBank readers.

The port's copy of ``genometools_tpu/core/seqio.py``
(JAX-free host code; the port imports nothing of the reference
package).

Capability equivalent of the reference GtSequenceBuffer / GtSeqIterator
(ref: src/core/sequence_buffer*.c). Parsing is numpy-vectorized: the whole
file is scanned once for newlines/headers and sequence payload is gathered
with boolean masks, so multi-MB FASTA files parse in milliseconds without a
Python per-line loop.

Transparent gzip/bzip2 decompression mirrors the reference's fa layer
(ref: src/core/fa.c).
"""

from __future__ import annotations

import bz2
import gzip
import io
import os
from dataclasses import dataclass, field

import numpy as np

_NL = ord("\n")
_GT = ord(">")
_AT = ord("@")
_PLUS = ord("+")


@dataclass
class SeqSet:
    """A parsed set of sequences: raw sequence bytes + descriptions."""

    seqs: list[np.ndarray] = field(default_factory=list)  # uint8 arrays
    descs: list[str] = field(default_factory=list)
    quals: list[np.ndarray] | None = None  # FASTQ only

    @property
    def num_sequences(self) -> int:
        return len(self.seqs)

    @property
    def total_length(self) -> int:
        return sum(len(s) for s in self.seqs)


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        if head[:2] == b"\x1f\x8b":
            return gzip.open(f).read()
        if head[:3] == b"BZh":
            return bz2.open(f).read()
        return f.read()


def parse_fasta_bytes(data: bytes) -> SeqSet:
    """Vectorized FASTA parser.

    Finds header lines ('>' at line start), gathers everything else minus
    newlines/whitespace as sequence payload.
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size == 0:
        return SeqSet()
    # line starts: position 0 and any position after a newline
    nl = np.flatnonzero(buf == _NL)
    line_starts = np.concatenate([[0], nl + 1])
    line_starts = line_starts[line_starts < buf.size]
    header_starts = line_starts[buf[line_starts] == _GT]
    if header_starts.size == 0:
        raise ValueError("not FASTA: no '>' header found")
    # line end for each header (a header at EOF has no newline)
    header_ends = np.searchsorted(nl, header_starts)
    if nl.size:
        header_ends = np.where(header_ends < nl.size,
                               nl[np.minimum(header_ends, nl.size - 1)],
                               buf.size)
    else:
        header_ends = np.full(header_ends.shape, buf.size)

    descs = [
        buf[s + 1:e].tobytes().decode("latin-1").rstrip("\r")
        for s, e in zip(header_starts, header_ends)
    ]

    # payload mask: not newline/CR/space/tab and not inside a header line
    # (single table gather instead of four whole-buffer compares)
    table = np.ones(256, bool)
    table[[_NL, ord("\r"), ord(" "), ord("\t")]] = False
    keep = table[buf]
    # mask header bytes directly (their trailing newlines are already
    # excluded): header bytes are a tiny fraction of the file, so an
    # explicit index list beats a whole-buffer interval cumsum
    hlen = header_ends - header_starts
    if hlen.size:
        offs = np.concatenate([[0], np.cumsum(hlen)[:-1]])
        hidx = (np.repeat(header_starts - offs, hlen)
                + np.arange(int(hlen.sum()), dtype=np.int64))
        keep[hidx] = False

    # record boundaries via counts of kept bytes before each header:
    # dropped positions (newlines/ws/header bytes) are sparse, so count
    # them with a searchsorted over their positions instead of a
    # whole-buffer cumsum
    payload = buf[keep]
    dropped = np.flatnonzero(~keep)
    bounds = np.empty(len(descs) + 1, np.int64)
    bounds[:-1] = header_starts - np.searchsorted(dropped, header_starts)
    bounds[-1] = payload.size
    seqs = [payload[bounds[i]:bounds[i + 1]] for i in range(len(descs))]
    return SeqSet(seqs=seqs, descs=descs)


def parse_fastq_bytes(data: bytes) -> SeqSet:
    """FASTQ parser (4-line records; multi-line records unsupported like most
    fast paths). Vectorized over line index arrays."""
    buf = np.frombuffer(data, dtype=np.uint8)
    nl = np.flatnonzero(buf == _NL)
    starts = np.concatenate([[0], nl + 1])
    ends = np.concatenate([nl, [buf.size]])
    if starts[-1] >= buf.size:  # trailing newline
        starts, ends = starts[:-1], ends[:-1]
    n_lines = starts.size
    if n_lines % 4 != 0:
        raise ValueError(f"FASTQ line count {n_lines} not divisible by 4")
    seqs, descs, quals = [], [], []
    for r in range(n_lines // 4):
        hs, he = starts[4 * r], ends[4 * r]
        if buf[hs] != _AT:
            raise ValueError(f"FASTQ record {r}: missing '@'")
        descs.append(buf[hs + 1:he].tobytes().decode("latin-1").rstrip("\r"))
        seqs.append(buf[starts[4 * r + 1]:ends[4 * r + 1]])
        if buf[starts[4 * r + 2]] != _PLUS:
            raise ValueError(f"FASTQ record {r}: missing '+'")
        quals.append(buf[starts[4 * r + 3]:ends[4 * r + 3]])
    return SeqSet(seqs=seqs, descs=descs, quals=quals)


def parse_embl_bytes(data: bytes) -> SeqSet:
    """EMBL flat file parser (ID/DE/SQ..// records, ref embl semantics)."""
    text = data.decode("latin-1")
    seqs, descs = [], []
    for record in text.split("//\n"):
        if "SQ " not in record and "SQ\n" not in record:
            continue
        desc = ""
        for line in record.splitlines():
            if line.startswith("DE"):
                desc = (desc + " " + line[2:].strip()).strip()
        sq = record.split("SQ", 1)[1]
        body = sq.split("\n", 1)[1] if "\n" in sq else ""
        letters = [c for c in body if c.isalpha()]
        seqs.append(np.frombuffer("".join(letters).encode("latin-1"), dtype=np.uint8))
        descs.append(desc)
    if not seqs:
        raise ValueError("not EMBL: no SQ records")
    return SeqSet(seqs=seqs, descs=descs)


def parse_genbank_bytes(data: bytes) -> SeqSet:
    """GenBank flat file parser (LOCUS/DEFINITION/ORIGIN..// records)."""
    text = data.decode("latin-1")
    seqs, descs = [], []
    for record in text.split("//\n"):
        if "ORIGIN" not in record:
            continue
        desc = ""
        grab = False
        dlines = []
        for line in record.splitlines():
            if line.startswith("DEFINITION"):
                grab = True
                dlines.append(line[len("DEFINITION"):].strip())
                continue
            if grab:
                if line.startswith(" "):
                    dlines.append(line.strip())
                    continue
                grab = False
        desc = " ".join(dlines).rstrip(".")
        body = record.split("ORIGIN", 1)[1]
        body = body.split("\n", 1)[1] if "\n" in body else ""
        letters = [c for c in body if c.isalpha()]
        seqs.append(np.frombuffer("".join(letters).encode("latin-1"), dtype=np.uint8))
        descs.append(desc)
    if not seqs:
        raise ValueError("not GenBank: no ORIGIN records")
    return SeqSet(seqs=seqs, descs=descs)


def guess_format(data: bytes) -> str:
    for i, b in enumerate(data[:4096]):
        if b in (0x20, 0x09, 0x0A, 0x0D):
            continue
        if b == _GT:
            return "fasta"
        if b == _AT:
            return "fastq"
        break
    head = data[:256].decode("latin-1", "replace")
    if head.startswith("ID ") or "\nID " in head:
        return "embl"
    if head.startswith("LOCUS"):
        return "genbank"
    raise ValueError("cannot guess sequence file format")


def read_seqfile(path: str, fmt: str | None = None) -> SeqSet:
    data = _read_bytes(path)
    fmt = fmt or guess_format(data)
    if fmt == "fasta":
        return parse_fasta_bytes(data)
    if fmt == "fastq":
        return parse_fastq_bytes(data)
    if fmt == "embl":
        return parse_embl_bytes(data)
    if fmt == "genbank":
        return parse_genbank_bytes(data)
    raise ValueError(f"unknown format {fmt!r}")


def read_seqfiles(paths: list[str]) -> SeqSet:
    out = SeqSet()
    for p in paths:
        s = read_seqfile(p)
        if s.quals is not None:
            if out.quals is None:
                # FASTA files read earlier contribute no qualities
                out.quals = [None] * len(out.seqs)
            out.quals.extend(s.quals)
        elif out.quals is not None:
            out.quals.extend([None] * len(s.seqs))
        out.seqs.extend(s.seqs)
        out.descs.extend(s.descs)
    return out


def write_fasta(path_or_file, seqs, descs, width: int = 80) -> None:
    """Write sequences as FASTA with fixed line width (ref: fasta.c)."""
    own = isinstance(path_or_file, (str, os.PathLike))
    f = open(path_or_file, "w") if own else path_or_file
    try:
        for seq, desc in zip(seqs, descs):
            f.write(f">{desc}\n")
            if isinstance(seq, np.ndarray):
                seq = seq.tobytes().decode("latin-1")
            for i in range(0, len(seq), width):
                f.write(seq[i:i + width])
                f.write("\n")
    finally:
        if own:
            f.close()
