"""GTF and BED parsing + GFF3<->GTF conversion.

The port's copy of ``genometools_tpu/anno/parsers.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalents of the reference parsers
(ref: src/extended/gtf_parser.c, bed_parser.c, tools gt_gtf_to_gff3.c,
gt_gff3_to_gtf.c, gt_bed_to_gff3.c).
"""

from __future__ import annotations

from .genome_node import FeatureNode, GenomeNode, Range, RegionNode


def parse_gtf(text: str) -> list[GenomeNode]:
    """GTF2.2 -> gene/mRNA/exon/CDS feature trees
    (ref: gtf_parser.c: group by gene_id/transcript_id)."""
    genes: dict[str, FeatureNode] = {}
    transcripts: dict[str, FeatureNode] = {}
    order: list[FeatureNode] = []
    stops: dict[str, list] = {}
    serial = 0
    for line_no, line in enumerate(text.splitlines(), 1):
        if not line.strip() or line.startswith("#"):
            continue
        cols = line.split("\t")
        if len(cols) < 9:
            raise ValueError(f"GTF line {line_no}: expected 9 fields")
        seqid, source, ftype, start, end, score, strand, phase, attrs = \
            cols[:9]
        if ftype not in ("exon", "CDS", "start_codon", "stop_codon",
                        "5UTR", "3UTR", "transcript", "gene"):
            continue
        ad = {}
        for part in attrs.strip().rstrip(";").split(";"):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition(" ")
            ad[key] = val.strip().strip('"')
        gid = ad.get("gene_id", "")
        tid = ad.get("transcript_id", "")
        start_i, end_i = int(start), int(end)
        serial += 1
        if gid not in genes:
            g = FeatureNode(seqid, "gene", start_i, end_i, strand, ".")
            g.serial = serial
            g.set_attribute("gene_id", gid)
            genes[gid] = g
            order.append(g)
        else:
            g = genes[gid]
            g.range = g.range.join(FeatureNode(
                seqid, "gene", start_i, end_i).range)
        if tid and tid not in transcripts:
            serial += 1
            t = FeatureNode(seqid, "mRNA", start_i, end_i, strand, ".")
            t.serial = serial
            t.set_attribute("transcript_id", tid)
            t.set_attribute("gene_id", gid)
            transcripts[tid] = t
            g.add_child(t)
        if ftype in ("exon", "CDS"):
            f = FeatureNode(seqid, ftype, start_i, end_i, strand, source,
                            None if score == "." else float(score),
                            phase if phase in "012" else ".")
            f.serial = serial
            for k, v in ad.items():
                f.set_attribute(k, v)
            t = transcripts.get(tid)
            if t is not None:
                t.add_child(f)
                t.range = t.range.join(f.range)
                genes[gid].range = genes[gid].range.join(f.range)
        if ftype == "stop_codon":
            stops.setdefault(tid, []).append((start_i, end_i, strand))
    # merge stop codons into their flanking CDS (GTF excludes the stop
    # codon from CDS; GFF3 includes it — ref: gtf_parser.c)
    for tid, slist in stops.items():
        t_node = transcripts.get(tid)
        if t_node is None:
            continue
        for s, e, strand in slist:
            cds = [c for c in t_node.children if c.type == "CDS"]
            merged = False
            for c in cds:
                if strand == "+" and c.range.end == s - 1:
                    c.range = Range(c.range.start, e)
                    merged = True
                    break
                if strand == "-" and c.range.start == e + 1:
                    c.range = Range(s, c.range.end)
                    merged = True
                    break
                if c.range.contains(Range(s, e)):
                    merged = True
                    break
            if not merged:
                raise ValueError(
                    f'stop codon for transcript "{tid}" with no flanking '
                    f"CDS")
    # reference output: all sequence regions, then feature blocks sorted
    # by seqid (region order in the golden follows the C hashmap and is
    # not reproduced; content compares equal)
    order.sort(key=lambda g: g.seqid)
    from .gff3 import add_missing_regions
    span = {}
    for g in order:
        r = span.get(g.seqid)
        span[g.seqid] = g.range if r is None else r.join(g.range)
    regions = [RegionNode(sid, rng.start, rng.end)
               for sid, rng in span.items()]
    return regions + order


def gff3_to_gtf(nodes: list[GenomeNode]) -> str:
    """Render feature trees as GTF (ref: gt_gff3_to_gtf / gtf_visitor)."""
    lines = []
    for node in nodes:
        if not isinstance(node, FeatureNode):
            continue
        gid_counter = getattr(gff3_to_gtf, "_gid", 0)
        for gene in [node] if node.type == "gene" else []:
            gid = gene.get_attribute("ID") or f"gene{gid_counter}"
            for t in gene.children:
                tid = t.get_attribute("ID") or f"{gid}.t"
                for c in t.children:
                    if c.type not in ("exon", "CDS"):
                        continue
                    score = "." if c.score is None else f"{c.score:g}"
                    lines.append("\t".join([
                        c.seqid, c.source, c.type, str(c.range.start),
                        str(c.range.end), score, c.strand, c.phase,
                        f'gene_id "{gid}"; transcript_id "{tid}";']))
    return "\n".join(lines) + ("\n" if lines else "")


def parse_bed(text: str) -> list[GenomeNode]:
    """BED -> feature trees (ref: bed_parser.c): BED blocks become
    exon children of a mRNA/BED_feature; thick range becomes CDS."""
    out: list[GenomeNode] = []
    offset = 0
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("track"):
            # track lines may carry an offset= applied to following rows
            # (ref: bed_parser.c track line handling)
            offset = 0
            for tok in line.split():
                if tok.startswith("offset="):
                    try:
                        offset = int(tok[7:].strip('"'))
                    except ValueError:
                        pass
            continue
        if not line or line.startswith(("#", "browser")):
            continue
        cols = line.split()
        if len(cols) < 3:
            continue
        seqid = cols[0]
        start = int(cols[1]) + 1 + offset
        end = int(cols[2]) + offset
        name = cols[3] if len(cols) > 3 else None
        score = float(cols[4]) if len(cols) > 4 and cols[4] != "." else None
        strand = cols[5] if len(cols) > 5 else "."
        f = FeatureNode(seqid, "BED_feature", start, end, strand, ".",
                        score)
        if name:
            f.set_attribute("Name", name)

        def child(ftype, s, e):
            c = FeatureNode(seqid, ftype, s, e, strand, ".", score)
            if name:
                c.set_attribute("Name", name)
            f.add_child(c)

        # thick range (ref: bed_parser.c BED_thick_feature child)
        if len(cols) > 7:
            ts, te = int(cols[6]) + 1 + offset, int(cols[7]) + offset
            if te >= ts:
                child("BED_thick_feature", ts, te)
        # blocks (ref: BED_block children)
        if len(cols) > 11:
            sizes = [int(x) for x in cols[10].rstrip(",").split(",")]
            starts = [int(x) for x in cols[11].rstrip(",").split(",")]
            for bs, sz in zip(starts, sizes):
                child("BED_block", start + bs, start + bs + sz - 1)
        out.append(f)
    # all sequence regions first, in seqid first-appearance order
    # (ref: gt bed_to_gff3 golden outputs)
    span = {}
    for fnode in out:
        r = span.get(fnode.seqid)
        span[fnode.seqid] = fnode.range if r is None \
            else r.join(fnode.range)
    regions = [RegionNode(sid, rng.start, rng.end)
               for sid, rng in span.items()]
    return regions + out
