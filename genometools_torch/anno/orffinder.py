"""ORF finding inside annotated features (gt orffinder).

The port's copy of ``genometools_tpu/anno/orffinder.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference ORF-finder visitor
(ref: src/extended/orf_finder_visitor.c, orf_iterator.c,
tools/gt_orffinder.c): for every feature of a requested type, scan its
genomic sequence (both strands, three frames each) for ORFs
(start codon .. last codon before a stop) and attach them as
`reading_frame` children of the innermost containing feature.
"""

from __future__ import annotations

from ..utils.seqtools import revcomp_str, translate_dna
from .genome_node import FeatureNode, GenomeNode, Range

ORF_TYPE = "reading_frame"
ORF_SOURCE = "GenomeTools"


def orf_iterator(seq: str):
    """Yield (start0, end0, frame) ORFs: start at the first ATG of the
    frame, end on the base before the next stop codon; ORFs without a
    stop codon are not reported (ref: orf_iterator.c)."""
    for frame in range(3):
        aminos = translate_dna(seq, frame)
        start = None
        for i, aa in enumerate(aminos):
            if aa == "M" and start is None:
                start = i * 3 + frame
            elif aa == "*" and start is not None:
                yield (start, i * 3 + frame - 1, frame)
                start = None


def _run_one(gf: FeatureNode, mapping, min_len: int, max_len: int,
             all_orfs: bool, serial_ref: list[int]) -> None:
    """ref: orf_finder_visitor.c:137 run_orffinder."""
    seq = mapping.get_sequence(gf.seqid, gf.range.start, gf.range.end)
    offset0 = gf.range.start - 1

    def attach(orf, strand):
        s0, e0, frame = orf
        if e0 - s0 + 1 < min_len or e0 - s0 + 1 > max_len:
            return
        if strand == "+":
            lo, hi = s0 + offset0 + 1, e0 + offset0 + 1
        else:
            sum0 = offset0 + len(seq) - 1
            lo, hi = sum0 - e0 + 1, sum0 - s0 + 1
        out_strand = strand
        if gf.strand == "-":
            out_strand = "-" if strand == "+" else "+"
        rng = Range(lo, hi)
        parent = None
        for node in gf.traverse():
            if node.type != ORF_TYPE and node.range.contains(rng):
                parent = node
        if parent is None:
            return
        child = FeatureNode(gf.seqid, ORF_TYPE, lo, hi, out_strand,
                            ORF_SOURCE)
        child.set_attribute("frame", str(frame))
        serial_ref[0] += 1
        child.serial = serial_ref[0]
        parent.add_child(child)

    for strand, s in (("+", seq), ("-", revcomp_str(seq))):
        if all_orfs:
            for orf in orf_iterator(s):
                attach(orf, strand)
        else:
            best = {}
            for orf in orf_iterator(s):
                cur = best.get(orf[2])
                if cur is None or orf[1] - orf[0] > cur[1] - cur[0]:
                    best[orf[2]] = orf
            for frame in range(3):
                if frame in best:
                    attach(best[frame], strand)


def find_orfs(nodes: list[GenomeNode], mapping, types=None,
              min_len: int = 30, max_len: int = 10000,
              all_orfs: bool = False) -> list[GenomeNode]:
    """gt orffinder: add reading_frame features (in place; returns
    nodes).  types=None searches in every feature."""
    max_serial = 0
    for n in nodes:
        if isinstance(n, FeatureNode):
            for m in n.traverse():
                max_serial = max(max_serial, m.serial)
    serial_ref = [max_serial]
    for top in nodes:
        if not isinstance(top, FeatureNode):
            continue
        for node in top.traverse():
            if node.type == ORF_TYPE:
                continue
            if types is None or node.type in types:
                _run_one(node, mapping, min_len, max_len, all_orfs,
                         serial_ref)
    return nodes
