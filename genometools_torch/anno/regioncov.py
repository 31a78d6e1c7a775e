"""Region coverage of features (gt dev regioncov).

The port's copy of ``genometools_tpu/anno/regioncov.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference regioncov visitor
(ref: src/extended/regioncov_visitor.c, tools/gt_regioncov.c): merge
the spans of consecutive top-level features into clusters (joining
ranges closer than maxfeaturedist) and print them per seqid.

Validated against testdata/gt_regioncov_test_{1,2}.out.
"""

from __future__ import annotations

from .genome_node import FeatureNode, GenomeNode, RegionNode


def region_coverage(nodes: list[GenomeNode],
                    max_feature_dist: int = 0) -> str:
    ranges: dict[str, list] = {}
    for n in nodes:
        if isinstance(n, RegionNode):
            ranges.setdefault(n.seqid, [])
        elif isinstance(n, FeatureNode):
            lst = ranges.setdefault(n.seqid, [])
            rng = n.range
            if lst:
                last = lst[-1]
                if last[1] + max_feature_dist >= rng.start and \
                        rng.end >= last[0]:
                    last[1] = max(last[1], rng.end)
                    continue
            lst.append([rng.start, rng.end])
    out = []
    for seqid in sorted(ranges):  # hashmap key order = sorted
        lst = ranges[seqid]
        if not lst:
            continue
        out.append(f"{seqid}:")
        for s, e in lst:
            out.append(f"{s}, {e}")
    return "\n".join(out) + ("\n" if out else "")
