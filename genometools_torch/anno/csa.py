"""Consensus spliced alignments (gt csa).

The port's copy of ``genometools_tpu/anno/csa.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference consensus_sa engine and csa
stream (ref: src/extended/consensus_sa.c, csa_stream/csa_visitor):
overlapping spliced alignments (gene->exon trees) on one sequence are
clustered, maximal compatible splice forms are extracted with the
L/R-set algorithm, and each cluster becomes one gene whose splice forms
are mRNAs with merged exons.

Validated against testdata/gt_csa_prob_{1..6}.{in,out} and the
U89959_sas -> U89959_csas golden.
"""

from __future__ import annotations

from dataclasses import dataclass

from .genome_node import FeatureNode, GenomeNode, Range, RegionNode


@dataclass
class SplicedAlignment:
    rng: Range
    strand: str
    exons: list          # list[(Range, score)]
    seqid: str
    source_node: FeatureNode


def _compatible(a: SplicedAlignment, b: SplicedAlignment) -> bool:
    """ref: consensus_sa.c:113 compatible()."""
    if a.strand != b.strand:
        return False
    if not a.rng.overlaps(b.rng):
        return False
    ex1 = [e[0] for e in a.exons]
    ex2 = [e[0] for e in b.exons]
    n1, n2 = len(ex1), len(ex2)
    i = j = 0
    start = None
    while i < n1 and j < n2:
        if ex1[i].overlaps(ex2[j]):
            start = (i, j)
            break
        if ex1[i].start < ex2[j].start:
            i += 1
        else:
            j += 1
    if start is None:
        return False
    i, j = start
    if not (i == 0 or j == 0):
        return False
    while i < n1 and j < n2:
        r1, r2 = ex1[i], ex2[j]
        if not r1.overlaps(r2):
            return False
        has_acc1 = i > 0
        has_acc2 = j > 0
        if has_acc1 or has_acc2:
            if has_acc1 and has_acc2 and r1.start != r2.start:
                return False
            if has_acc1 and r2.start < r1.start:
                return False
            if has_acc2 and r1.start < r2.start:
                return False
        has_don1 = i < n1 - 1
        has_don2 = j < n2 - 1
        if has_don1 or has_don2:
            if has_don1 and has_don2 and r1.end != r2.end:
                return False
            if has_don1 and r2.end > r1.end:
                return False
            if has_don2 and r1.end > r2.end:
                return False
        i += 1
        j += 1
    return True


def consensus_splice_forms(sas: list[SplicedAlignment]) -> list[list[int]]:
    """The L/R bitset algorithm (ref: compute_csas, consensus_sa.c:458).
    Returns splice forms as lists of SA indices, in extraction order."""
    n = len(sas)
    comp = [[_compatible(sas[x], sas[y]) for y in range(n)]
            for x in range(n)]
    C = [set() for _ in range(n)]
    for x in range(n):
        for y in range(n):
            if sas[x].rng.contains(sas[y].rng) and comp[x][y]:
                C[x].add(y)
    left = [set() for _ in range(n)]
    right = [set() for _ in range(n)]
    for x in range(n):
        for y in range(n):
            rx, ry = sas[x].rng, sas[y].rng
            if rx.start > ry.start and rx.end > ry.end and comp[x][y]:
                left[x].add(y)   # y lies left of x
            if rx.start < ry.start and rx.end < ry.end and comp[x][y]:
                right[x].add(y)
    L = [set() for _ in range(n)]
    for x in range(n):
        if not left[x]:
            L[x] = set(C[x])
        else:
            best = None
            best_size = -1
            for y in sorted(left[x]):
                size = len(L[y] | C[x])
                if size > best_size:
                    best, best_size = y, size
            L[x] = L[best] | C[x]
    R = [set() for _ in range(n)]
    for x in range(n - 1, -1, -1):
        if not right[x]:
            R[x] = set(C[x])
        else:
            best = None
            best_size = -1
            for y in sorted(right[x]):
                size = len(R[y] | C[x])
                if size > best_size:
                    best, best_size = y, size
            R[x] = R[best] | C[x]
    forms = []
    U = set(range(n))
    while U:
        best = None
        best_set = None
        for x in sorted(U):
            s = L[x] | R[x]
            if best is None or len(s) > len(best_set):
                best, best_set = x, s
        forms.append(sorted(best_set))
        U -= best_set
    return forms


def _extract_sas(nodes: list[GenomeNode]) -> list[SplicedAlignment]:
    sas = []
    for node in nodes:
        if not isinstance(node, FeatureNode):
            continue
        exons = []
        for m in node.traverse():
            if m.type == "exon":
                exons.append((m.range, m.score))
        exons.sort(key=lambda e: (e[0].start, e[0].end))
        if exons:
            sas.append(SplicedAlignment(node.range, node.strand, exons,
                                        node.seqid, node))
    return sas


def csa(nodes: list[GenomeNode], join_length: int = 300
        ) -> list[GenomeNode]:
    """gt csa: replace overlapping spliced alignments by consensus genes.

    Input must be sorted by range like the reference (raises otherwise).
    """
    sas = _extract_sas(nodes)
    for a, b in zip(sas, sas[1:]):
        if (b.rng.start, b.rng.end) < (a.rng.start, a.rng.end):
            raise ValueError("input file is not sorted")
    out: list[GenomeNode] = [n for n in nodes
                             if isinstance(n, RegionNode)]
    # cluster alignments whose ranges chain within join_length
    # (ref: csa_visitor.c:86 first_range.end + join_length >= start)
    clusters: list[list[SplicedAlignment]] = []
    cluster_end = None
    for sa in sas:
        if clusters and clusters[-1][0].seqid == sa.seqid and \
                cluster_end + join_length >= sa.rng.start:
            clusters[-1].append(sa)
            cluster_end = max(cluster_end, sa.rng.end)
        else:
            clusters.append([sa])
            cluster_end = sa.rng.end
    for cluster in clusters:
        forms = [[0]] if len(cluster) == 1 \
            else consensus_splice_forms(cluster)
        out.extend(_render_cluster(cluster, forms))
    return out


def _range_compare(a: Range, b: Range) -> int:
    if (a.start, a.end) < (b.start, b.end):
        return -1
    if (a.start, a.end) > (b.start, b.end):
        return 1
    return 0


def _merge_exons(members: list[SplicedAlignment]):
    """Sequential per-SA merge mirroring the reference exactly
    (ref: csa_visitor.c:234 add_sa_to_exon_feature_array): extending an
    accumulated exon's right border adopts the extender's score; an
    identical range takes the max; contained exons leave the score."""
    acc: list[list] = []  # [Range, score]
    for m in members:
        ei = 0
        si = 0
        sa_exons = m.exons
        while ei < len(acc) and si < len(sa_exons):
            erng, esc = acc[ei]
            srng, ssc = sa_exons[si]
            cmp = _range_compare(erng, srng)
            if cmp == -1:
                if erng.overlaps(srng):
                    if not erng.contains(srng):
                        acc[ei][0] = Range(erng.start, srng.end)
                        if ssc is not None:
                            acc[ei][1] = ssc
                    si += 1
                ei += 1
            elif cmp == 0:
                if (esc is not None and ssc is not None and esc < ssc) or \
                        (esc is None and ssc is not None):
                    acc[ei][1] = ssc
                ei += 1
                si += 1
            else:
                if srng.end > erng.end:
                    acc[ei][0] = Range(erng.start, srng.end)
                    if ssc is not None:
                        acc[ei][1] = ssc
                ei += 1
                si += 1
        for rng, sc in sa_exons[si:]:
            acc.append([rng, sc])
    return [(r, s) for r, s in acc]


def _render_cluster(cluster, forms) -> list[FeatureNode]:
    """Splice forms of one cluster split into at most one forward and one
    reverse gene, emitted range-sorted
    (ref: csa_variable_strands.c:51 process_splice_forms)."""
    seqid = cluster[0].seqid
    genes = {}
    for form in forms:
        members = [cluster[i] for i in form]
        strand = members[0].strand
        fr = members[0].rng
        for m in members[1:]:
            fr = fr.join(m.rng)
        gene = genes.get(strand)
        if gene is None:
            gene = FeatureNode(seqid, "gene", fr.start, fr.end, strand,
                               "gt csa")
            genes[strand] = gene
        else:
            gene.range = gene.range.join(fr)
        mrna = FeatureNode(seqid, "mRNA", fr.start, fr.end, strand,
                           "gt csa")
        # concatenate members' Target attributes
        # (ref: csa_visitor.c:363 mRNA_set_target_attribute)
        targets = [m.source_node.get_attribute("Target")
                   for m in members
                   if m.source_node.get_attribute("Target")]
        if targets:
            mrna.set_attribute("Target", ",".join(targets))
        gene.add_child(mrna)
        for rng, sc in _merge_exons(members):
            ex = FeatureNode(seqid, "exon", rng.start, rng.end, strand,
                             "gt csa", sc)
            mrna.add_child(ex)
    return sorted(genes.values(),
                  key=lambda g: (g.range.start, g.range.end))
