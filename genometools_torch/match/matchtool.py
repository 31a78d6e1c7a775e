"""Match-file parsing (gt matchtool).

The port's copy of ``genometools_tpu/match/matchtool.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference match iterators
(ref: src/extended/match_iterator_open.c, match_iterator_blast.c,
tools/gt_matchtool.c): parse OPENMATCH / BLASTOUT (tabular) match
files and print normalized match tables.

Validated against testdata/matchtool_open.out, matchtool_blast.out and
the corrupt/neg/empty error cases.
"""

from __future__ import annotations


def parse_open_matches(text: str) -> str:
    """11-column OPENMATCH format: len1 seqid1 start1 dir len2 seqid2
    start2 distance evalue weight identity."""
    out = ["seqid1\tseqid2\tstartpos1\tstartpos2\tendpos1\tendpos2"
           "\tweight"]
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        cols = line.split()
        if len(cols) != 11:
            raise ValueError("invalid format")
        len1, sid1, start1, _d, len2, sid2, start2 = cols[:7]
        weight = cols[9]
        for v in (len1, start1, len2, start2, weight):
            if not v.isdigit():
                raise ValueError("non-negative integer expected")
        out.append(f"{sid1}\t{sid2}\t{start1}\t{start2}\t"
                   f"{int(start1) + int(len1) - 1}\t"
                   f"{int(start2) + int(len2) - 1}\t{weight}")
    return "\n".join(out) + "\n"


def parse_blast_matches(text: str) -> str:
    """Tabular BLAST output with comment lines (-m 9 style)."""
    out = ["query\tdbname2\tq.startpos\td.startpos\tq.endpos\td.endpos"
           "\tbit score\tevalue\tali length"]
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        cols = line.split()
        if len(cols) != 12:
            raise ValueError("invalid format")
        (qid, sid, _ident, alilen, _mism, _gaps, qstart, qend, sstart,
         send, evalue, bits) = cols
        for v in (alilen, qstart, qend, sstart, send):
            if not v.isdigit():
                raise ValueError("non-negative integer expected")
        # minus-strand hits have sstart > send; ranges are normalized
        # to ascending (ref: match_iterator_blast.c)
        ds, de = sorted((int(sstart), int(send)))
        qs, qe = sorted((int(qstart), int(qend)))
        out.append(f"{qid}\t{sid}\t{qs}\t{ds}\t{qe}\t{de}\t"
                   f"{float(bits):.3f}\t{evalue}\t{alilen}")
    return "\n".join(out) + "\n"
