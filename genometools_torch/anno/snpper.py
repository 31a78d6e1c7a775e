"""SNP effect annotation (gt snpper).

The port's copy of ``genometools_tpu/anno/snpper.py`` (JAX-free
host code; the port imports nothing of the reference package).

Re-implements the reference's SNP annotator
(ref: src/extended/snp_annotator_stream.c,
src/extended/snp_annotator_visitor.c, tool src/tools/gt_snpper.c):
merge a sorted genome annotation (GFF3) with a sorted variant file
(GVF), cluster overlapping genes, and annotate every SNV/SNP falling
into a gene cluster with its coding effect per mRNA, appended to the
GVF `Variant_effect` attribute as
``<effect> <variant_index> <mRNA_type> <mRNA_ID>``.

Effects (ref: snp_annotator_visitor.c:54-58):
  * stop codon -> stop codon      stop_retained_variant
  * stop codon -> other           stop_lost
  * other -> stop codon           stop_gained
  * same amino acid               synonymous_variant
  * different amino acid          non_conservative_missense_variant

Output carries the annotated SNP nodes plus meta/region/comment nodes;
annotation genes and other feature types are consumed (reference
behavior).  One deliberate divergence: the reference's stream drops
SNPs still queued inside the last gene cluster at EOF
(snp_annotator_stream.c:121 breaks without a final flush); we flush
and emit them.
"""

from __future__ import annotations

from ..core.trans_table import TransTable
from .genome_node import FeatureNode, Range

_COMPLEMENT = str.maketrans("acgtACGT", "tgcaTGCA")

MISSENSE = "non_conservative_missense_variant"
NONSENSE = "stop_gained"
STOP_LOST = "stop_lost"
SYNONYMOUS = "synonymous_variant"
SYNONYMOUS_STOP = "stop_retained_variant"

SNP_TYPES = ("SNV", "SNP")


def _revcomp(s: str) -> str:
    return s.translate(_COMPLEMENT)[::-1]


def _prepare_mrna_seqs(gene: FeatureNode, rmap) -> dict[int, str]:
    """id(mRNA) -> spliced CDS sequence (revcomp when the gene is on the
    reverse strand).  ref: gt_snp_annotator_visitor_prepare_gene."""
    seqs: dict[int, str] = {}
    for mrna in gene.traverse():
        if mrna.type != "mRNA":
            continue
        parts = []
        for node in mrna.traverse():
            if node.type == "CDS":
                parts.append(rmap.get_sequence(gene.seqid, node.start,
                                               node.end))
        seq = "".join(parts)
        if gene.strand == "-":
            seq = _revcomp(seq)
        seqs[id(mrna)] = seq
    return seqs


def _classify(tt: TransTable, mrnaseq: str, pos: int, variant_char: str
              ) -> str | None:
    """Effect of variant_char at mRNA position pos
    (ref: snp_annotator_classify_snp)."""
    start = (pos // 3) * 3
    codon = mrnaseq[start:start + 3]
    if len(codon) < 3:
        return None
    vc = list(codon)
    vc[pos % 3] = variant_char
    variant_codon = "".join(vc)
    try:
        if tt.is_stop_codon(*codon):
            return (SYNONYMOUS_STOP if tt.is_stop_codon(*variant_codon)
                    else STOP_LOST)
        if tt.is_stop_codon(*variant_codon):
            return NONSENSE
        old = tt.translate(*codon)
        new = tt.translate(*variant_codon)
    except ValueError:
        return None
    return SYNONYMOUS if new == old else MISSENSE


def _annotate_snp(snp: FeatureNode, gene: FeatureNode,
                  mrna_seqs: dict[int, str], tt: TransTable) -> None:
    """Visit one SNP against one gene
    (ref: snp_annotator_visitor_feature_node)."""
    snp_rng = Range(snp.start, snp.end)
    for mrna in gene.children:              # direct children only
        if mrna.type != "mRNA":
            continue
        mrnaseq = mrna_seqs.get(id(mrna))
        if not mrnaseq:
            continue
        reverse = mrna.strand == "-"
        # walk the CDS segments in order, accumulating the lengths of the
        # ones upstream of the SNP so `pos` is the SNP's offset inside the
        # spliced mRNA (ref: snp_annotator_visitor.c:216 — non-overlapping
        # CDS add gt_range_length(&cds_rng) to mrnasnppos)
        pos = None
        acc = 0
        for node in mrna.traverse():
            if node.type != "CDS":
                continue
            cds_rng = Range(node.start, node.end)
            if snp_rng.overlaps(cds_rng):
                pos = acc + snp.start - node.start
                break
            acc += node.end - node.start + 1
        if pos is None:
            continue
        if reverse:
            pos = len(mrnaseq) - pos - 1
        if not 0 <= pos < len(mrnaseq):
            continue
        origchar = mrnaseq[pos]
        variant = snp.get_attribute("Variant_seq") or ""
        idx = 0
        for ch in variant:
            if ch == ";":
                break
            if ch == ",":
                continue
            if ch == origchar:
                # ref: `else if (*variantchars == origchar) i++;`
                idx += 1
                continue
            vch = ch.translate(_COMPLEMENT) if reverse else ch
            effect = _classify(tt, mrnaseq, pos, vch)
            if effect is None:
                idx += 1
                continue
            entry = (f"{effect} {idx} {mrna.type} "
                     f"{mrna.get_attribute('ID')}")
            prev = snp.get_attribute("Variant_effect")
            snp.set_attribute("Variant_effect",
                              f"{prev},{entry}" if prev else entry)
            idx += 1


def snp_annotator_stream(gvf_nodes, gff_nodes, rmap,
                         tt: TransTable | None = None):
    """Yield annotated GVF nodes (ref: gt_snp_annotator_stream_new).

    Both inputs must be position-sorted; they are merged and genes are
    clustered by range overlap.  Genes and non-SNP features are
    consumed; SNPs and meta/region/comment nodes are emitted.
    """
    from .node_stream import merge_stream

    tt = tt or TransTable()
    cluster: list[FeatureNode] = []
    cluster_range: Range | None = None
    snps: list[FeatureNode] = []

    def flush():
        if snps:
            for gene in cluster:
                mrna_seqs = _prepare_mrna_seqs(gene, rmap)
                for snp in snps:
                    _annotate_snp(snp, gene, mrna_seqs, tt)
        out = list(snps)
        cluster.clear()
        snps.clear()
        return out

    for node in merge_stream([gvf_nodes, gff_nodes]):
        if isinstance(node, FeatureNode):
            rng = Range(node.start, node.end)
            if node.type in SNP_TYPES:
                if cluster_range is not None and \
                        rng.overlaps(cluster_range):
                    snps.append(node)
                else:
                    yield from flush()
                    cluster_range = None
                    yield node
            elif node.type == "gene":
                if not cluster:
                    cluster.append(node)
                    cluster_range = rng
                elif rng.overlaps(cluster_range):
                    cluster.append(node)
                    cluster_range = cluster_range.join(rng)
                else:
                    yield from flush()
                    cluster.append(node)
                    cluster_range = rng
            # other feature types: consumed (reference behavior)
        else:
            yield from flush()
            cluster_range = None
            yield node
    yield from flush()
