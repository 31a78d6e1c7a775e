"""Splice site statistics (gt splicesiteinfo).

The port's copy of ``genometools_tpu/anno/splicesite.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference splice-site-info visitor
(ref: src/extended/splice_site_info_visitor.c,
tools/gt_splicesiteinfo.c): collect donor/acceptor dinucleotides of
every intron feature (>= 4bp) and print their distributions.

Validated against testdata/gt_splicesiteinfo_test_{1,2,4,5}.out.
"""

from __future__ import annotations

import warnings

from ..utils.seqtools import revcomp_str
from .genome_node import FeatureNode, GenomeNode


def splice_site_info(nodes: list[GenomeNode], mapping,
                     addintrons: bool = False) -> str | None:
    """Return the report text, or None if no intron was processed
    (the CLI then warns like the reference)."""
    if addintrons:
        from .node_stream import add_introns_stream
        nodes = list(add_introns_stream(nodes))
    splicesites: dict[str, int] = {}
    donors: dict[str, int] = {}
    acceptors: dict[str, int] = {}
    intron_processed = False
    show = False
    for top in nodes:
        if not isinstance(top, FeatureNode):
            continue
        for fn in top.traverse():
            if fn.type != "intron":
                continue
            intron_processed = True
            if fn.range.length < 4:
                continue
            seq = mapping.get_sequence(fn.seqid, fn.range.start,
                                       fn.range.end)
            if fn.strand not in "+-":
                warnings.warn("skipping intron with unknown orientation "
                              f"(line {getattr(fn, 'line_number', 0)})")
                continue
            site = (seq[0] + seq[1] + seq[-2] + seq[-1]).lower()
            if fn.strand == "-":
                site = revcomp_str(site)
            splicesites[site] = splicesites.get(site, 0) + 1
            donors[site[:2]] = donors.get(site[:2], 0) + 1
            acceptors[site[2:]] = acceptors.get(site[2:], 0) + 1
            show = True
    if not intron_processed:
        return None
    if not show:
        return ""
    out = []

    def section(title, dist, fmt):
        out.append(title)
        total = sum(dist.values())
        for key in sorted(dist):  # cstr-hashmap default order is sorted
            out.append(f"{fmt(key)}: {dist[key] / total * 100.0:6.2f}% "
                       f"(n={dist[key]})")

    section("splice site distribution (for introns >= 4bp)", splicesites,
            lambda k: f"{k[:2]}-{k[2:]}")
    out.append("")
    section("donor site distribution (for introns >= 4bp)", donors,
            lambda k: k)
    out.append("")
    section("acceptor site distribution (for introns >= 4bp)", acceptors,
            lambda k: k)
    return "\n".join(out) + "\n"
