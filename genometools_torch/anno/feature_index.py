"""In-memory feature index with interval queries + feature extraction.

The port's copy of ``genometools_tpu/anno/feature_index.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalents of the reference feature index and extractfeat
(ref: src/extended/feature_index_memory.c, feature_index.c,
gt_extractfeat.c / extract_feature_stream.c).
"""

from __future__ import annotations

import bisect

import numpy as np

from ..core.seqio import SeqSet
from ..utils.seqtools import revcomp_str
from .genome_node import FeatureNode, GenomeNode, Range, RegionNode


class FeatureIndex:
    """seqid -> features sorted by start; range queries by binary search +
    scan (the reference uses an interval tree; sorted-array bisection has
    the same complexity for query-heavy loads and is vectorizable)."""

    def __init__(self):
        self._by_seqid: dict[str, list[FeatureNode]] = {}
        self._regions: dict[str, Range] = {}
        self._sorted = False

    def add_gff3(self, nodes: list[GenomeNode]) -> None:
        for n in nodes:
            if isinstance(n, FeatureNode):
                self._by_seqid.setdefault(n.seqid, []).append(n)
            elif isinstance(n, RegionNode):
                self._regions[n.seqid] = n.range
        self._sorted = False

    def _ensure_sorted(self):
        if not self._sorted:
            for lst in self._by_seqid.values():
                lst.sort(key=lambda f: (f.range.start, f.range.end))
            self._sorted = True

    def seqids(self) -> list[str]:
        return sorted(self._by_seqid)

    def features_for_seqid(self, seqid: str) -> list[FeatureNode]:
        self._ensure_sorted()
        return list(self._by_seqid.get(seqid, []))

    def features_for_range(self, seqid: str, start: int, end: int
                           ) -> list[FeatureNode]:
        """All top-level features overlapping [start, end]
        (ref: gt_feature_index_get_features_for_range)."""
        self._ensure_sorted()
        lst = self._by_seqid.get(seqid, [])
        q = Range(start, end)
        return [f for f in lst if f.range.overlaps(q)]

    def first_feature(self, seqid: str) -> FeatureNode | None:
        self._ensure_sorted()
        lst = self._by_seqid.get(seqid, [])
        return lst[0] if lst else None

    def range_for_seqid(self, seqid: str) -> Range | None:
        if seqid in self._regions:
            return self._regions[seqid]
        lst = self._by_seqid.get(seqid)
        if not lst:
            return None
        return Range(min(f.range.start for f in lst),
                     max(f.range.end for f in lst))


def extract_features(nodes: list[GenomeNode], seqs: dict[str, str],
                     ftype: str = "exon", join: bool = False,
                     translate: bool = False) -> SeqSet:
    """gt extractfeat: pull feature sequences out of region sequences.

    join=True concatenates all `ftype` children per top-level feature
    (e.g. spliced transcript from exons), honoring strand.
    (ref: src/extended/extract_feature_stream.c)
    """
    from ..utils.seqtools import translate_dna
    out = SeqSet()
    for node in nodes:
        if not isinstance(node, FeatureNode):
            continue
        seq = seqs.get(node.seqid)
        if seq is None:
            continue
        parts = []
        for f in node.traverse():
            if f.type == ftype:
                parts.append((f.range.start, f.range.end, f.strand))
        if not parts:
            continue
        parts.sort()
        if join:
            s = "".join(seq[a - 1:b] for a, b, _ in parts)
            if parts[0][2] == "-":
                s = revcomp_str(s)
            if translate:
                s = translate_dna(s)
            out.seqs.append(np.frombuffer(s.encode(), np.uint8))
            out.descs.append(f"{node.type} {node.seqid}")
        else:
            for a, b, strand in parts:
                s = seq[a - 1:b]
                if strand == "-":
                    s = revcomp_str(s)
                if translate:
                    s = translate_dna(s)
                out.seqs.append(np.frombuffer(s.encode(), np.uint8))
                out.descs.append(f"{ftype} {node.seqid}:{a}..{b}")
    return out
