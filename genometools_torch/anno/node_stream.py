"""Node streams: pull-based annotation pipeline.

The port's copy of ``genometools_tpu/anno/node_stream.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference GtNodeStream architecture
(ref: src/extended/node_stream_api.h:25-74, gt_node_stream_next) and the
most-used concrete streams (gff3_in_stream.c, gff3_out_stream_api.c,
sort_stream.c, merge_stream.c, add_introns_stream.c, select_stream.c,
stat_stream.c, uniq_stream.c, inter_feature_stream.c).

A stream is any iterator of GenomeNode; combinators are generator
functions, which keeps the pull semantics (`next_tree`) of the reference
without the C boilerplate.
"""

from __future__ import annotations

from typing import Iterable, Iterator

from .genome_node import (CommentNode, FeatureNode, GenomeNode, MetaNode,
                          Range, RegionNode, SequenceNode)
from .gff3 import parse_gff3


def gff3_in_stream(paths_or_text, strict: bool = True) -> Iterator[GenomeNode]:
    """ref: gff3_in_stream.c — parse one or more files into a node flow."""
    if isinstance(paths_or_text, str) and "\n" in paths_or_text:
        yield from parse_gff3(paths_or_text, strict=strict)
        return
    paths = [paths_or_text] if isinstance(paths_or_text, str) else paths_or_text
    for p in paths:
        with open(p) as f:
            yield from parse_gff3(f.read(), strict=strict)


def _node_sort_key(node: GenomeNode):
    """ref: gt_genome_node_compare — regions first, then features by
    (seqid, range); comments/metas keep document position at the front."""
    if isinstance(node, RegionNode):
        return (0, node.seqid, 0, 0)
    if isinstance(node, (MetaNode, CommentNode)):
        return (1, "", 0, 0)
    if isinstance(node, SequenceNode):
        return (3, "", 0, 0)
    return (2, node.seqid or "", node.range.start if node.range else 0,
            -(node.range.end if node.range else 0))


def sort_stream(stream: Iterable[GenomeNode]) -> Iterator[GenomeNode]:
    """ref: sort_stream.c — buffer everything, emit in sorted order
    (stable for equal keys)."""
    yield from sorted(stream, key=_node_sort_key)


def merge_stream(streams: list[Iterable[GenomeNode]]) -> Iterator[GenomeNode]:
    """ref: merge_stream.c — merge sorted streams keeping global order."""
    import heapq
    iters = [iter(s) for s in streams]
    heap = []
    for i, it in enumerate(iters):
        for node in it:
            heap.append((_node_sort_key(node), i, id(node), node))
    heap.sort(key=lambda t: (t[0], t[1]))
    for _, _, _, node in heap:
        yield node


def select_stream(stream, seqid: str | None = None,
                  typefilter: str | None = None,
                  max_gene_length: int | None = None,
                  min_gene_score: float | None = None,
                  contain: Range | None = None,
                  overlap: Range | None = None) -> Iterator[GenomeNode]:
    """ref: select_stream.c / gt select tool filters."""
    for node in stream:
        if not isinstance(node, FeatureNode):
            yield node
            continue
        if seqid is not None and node.seqid != seqid:
            continue
        if typefilter is not None and all(
                n.type != typefilter for n in node.traverse()):
            continue
        if max_gene_length is not None and node.type == "gene" and \
                node.range.length > max_gene_length:
            continue
        if min_gene_score is not None and node.type == "gene" and \
                (node.score is None or node.score < min_gene_score):
            continue
        if contain is not None and not contain.contains(node.range):
            continue
        if overlap is not None and not overlap.overlaps(node.range):
            continue
        yield node


def _place_inter_features(parent, outside_type: str, inter_type: str):
    """Shared placement walk: children in document order; an overlapping
    boundary is skipped WITHOUT advancing the previous feature (matches
    the reference's warning path, validated against
    gt_gff3_addintrons_overlapping_exons_with_introns.gff3)."""
    outs = sorted([c for c in parent.children if c.type == outside_type],
                  key=lambda c: c.serial)
    prev = None
    for c in outs:
        if prev is None:
            prev = c
            continue
        if c.range.start <= prev.range.end:
            continue  # overlapping boundary: no inter feature, keep prev
        if c.range.start > prev.range.end + 1:
            mid = FeatureNode(parent.seqid, inter_type, prev.range.end + 1,
                              c.range.start - 1, c.strand, c.source)
            parent.add_child(mid)
        prev = c


def add_introns_stream(stream) -> Iterator[GenomeNode]:
    """ref: add_introns_stream.c / gt gff3 -addintrons: insert intron
    features between consecutive exons of each parent."""
    for node in stream:
        if isinstance(node, FeatureNode):
            for n in node.traverse():
                if any(c.type == "intron" for c in n.children):
                    continue
                _place_inter_features(n, "exon", "intron")
        yield node


def inter_feature_stream(stream, outside_type: str, inter_type: str
                         ) -> Iterator[GenomeNode]:
    """ref: inter_feature_stream.c / gt interfeat: add <inter_type>
    features between consecutive <outside_type> children."""
    for node in stream:
        if isinstance(node, FeatureNode):
            for n in node.traverse():
                _place_inter_features(n, outside_type, inter_type)
        yield node


def uniq_stream(stream) -> Iterator[GenomeNode]:
    """ref: uniq_stream.c — drop repeated identical feature trees
    (same type/range/strand and identical children shapes)."""
    def sig(node: FeatureNode):
        return (node.seqid, node.type, node.range.start, node.range.end,
                node.strand,
                tuple(sorted(sig(c) for c in node.children)))

    seen = set()
    for node in stream:
        if isinstance(node, FeatureNode):
            s = sig(node)
            if s in seen:
                continue
            seen.add(s)
        yield node


class FeatureStats:
    """ref: stat_stream.c / gt stat output."""

    def __init__(self):
        self.counts: dict[str, int] = {}
        self.total_features = 0

    def add(self, node: FeatureNode):
        for n in node.traverse():
            self.counts[n.type] = self.counts.get(n.type, 0) + 1
            self.total_features += 1

    def report(self) -> list[str]:
        out = [f"{t}s: {c}" for t, c in sorted(self.counts.items())]
        return out


def stat_stream(stream, stats: FeatureStats) -> Iterator[GenomeNode]:
    for node in stream:
        if isinstance(node, FeatureNode):
            stats.add(node)
        yield node


def chseqids_stream(stream, mapping: dict[str, str]):
    """ref: gt chseqids / chseqids_stream.c — substitute sequence ids per
    a mapping file; region nodes that map onto the same new id are merged
    into one region spanning the union of their ranges."""
    regions: dict[str, RegionNode] = {}
    buffered = []
    for node in stream:
        if isinstance(node, RegionNode):
            new = mapping.get(node.seqid, node.seqid)
            node.seqid = new
            if new in regions:
                prev = regions[new]
                prev.range = Range(min(prev.range.start, node.range.start),
                                   max(prev.range.end, node.range.end))
            else:
                regions[new] = node
                buffered.append(node)
            continue
        if isinstance(node, FeatureNode) and node.seqid in mapping:
            for n in node.traverse():
                n.seqid = mapping[n.seqid] if n.seqid in mapping \
                    else n.seqid
        buffered.append(node)
    yield from buffered


def dupfeat_stream(stream, dest_type: str, source_type: str):
    """ref: gt dupfeat — duplicate features of source_type as dest_type."""
    for node in stream:
        if isinstance(node, FeatureNode):
            for n in list(node.traverse()):
                for c in list(n.children):
                    if c.type == source_type:
                        dup = FeatureNode(c.seqid, dest_type,
                                          c.range.start, c.range.end,
                                          c.strand, c.source, c.score,
                                          c.phase)
                        dup.serial = c.serial
                        n.add_child(dup)
        yield node


def mergefeat_stream(stream):
    """ref: gt mergefeat / merge_feature_visitor.c mergefeat_in_children —
    merge only ADJACENT (prev.end+1 == cur.start) same-type siblings that
    both have no children; the merged feature's score is unset."""
    for node in stream:
        if isinstance(node, FeatureNode):
            to_remove = set()
            for n in node.traverse():
                prev_by_type: dict[str, FeatureNode] = {}
                for c in n.children:
                    prev = prev_by_type.pop(c.type, None)
                    if prev is not None and \
                            prev.range.end + 1 == c.range.start and \
                            not prev.children and not c.children:
                        prev.range = Range(prev.range.start, c.range.end)
                        prev.score = None
                        to_remove.add(id(c))
                    prev_by_type[c.type] = c
            if to_remove:
                for n in node.traverse():
                    n.children = [c for c in n.children
                                  if id(c) not in to_remove]
        yield node


def id_to_md5_stream(stream, seqs: dict[str, str]):
    """ref: gt id_to_md5 — translate seqids to md5:<hex>:<id> fingerprints
    (ref: src/extended/id_to_md5_visitor.c, md5_seqid.h format)."""
    import hashlib
    mapping = {sid: "md5:" + hashlib.md5(s.upper().encode()).hexdigest()
               + ":" + sid
               for sid, s in seqs.items()}
    yield from chseqids_stream(stream, mapping)


def md5_to_id_stream(stream, seqs: dict[str, str] | None = None):
    """ref: gt md5_to_id — reverse translation. The new md5 seqid format
    embeds the original id after the second ':' so no sequence lookup is
    needed (ref: md5_to_id_visitor.c GT_MD5_SEQID_TOTAL_LEN path)."""
    from .md5translate import md5_to_id_nodes
    yield from md5_to_id_nodes(stream)


# ---------------------------------------------------------------------------
# buffer / array / visitor / load family (ref: src/extended/
# buffer_stream.c, array_in_stream.c, array_out_stream.c,
# visitor_stream.c, load_stream.c)
# ---------------------------------------------------------------------------

class BufferStream:
    """ref: buffer_stream.c — while `buffering`, pull from the input and
    queue a reference to every node; after `dequeue_buffer()` the queued
    nodes replay before the remaining input."""

    def __init__(self, in_stream: Iterable[GenomeNode]):
        self._in = iter(in_stream)
        self._buf: list[GenomeNode] = []
        self.buffering = True

    def dequeue_buffer(self) -> None:
        self.buffering = False

    def __iter__(self):
        return self

    def __next__(self) -> GenomeNode:
        if self.buffering:
            node = next(self._in)
            self._buf.append(node)
            return node
        if self._buf:
            return self._buf.pop(0)
        return next(self._in)


def array_in_stream(nodes: list[GenomeNode]) -> Iterator[GenomeNode]:
    """ref: array_in_stream.c — emit the nodes of an in-memory array."""
    yield from nodes


def array_out_stream(stream, out_nodes: list,
                     store_all: bool = False) -> Iterator[GenomeNode]:
    """ref: array_out_stream.c — pass-through that appends every
    feature node (or, with store_all, every node) to `out_nodes`."""
    for node in stream:
        if store_all or isinstance(node, FeatureNode):
            out_nodes.append(node)
        yield node


def visitor_stream(stream, visitor) -> Iterator[GenomeNode]:
    """ref: visitor_stream.c — accept() every node with the given
    visitor (an object with visit_* methods or a plain callable), then
    pass it downstream."""
    for node in stream:
        if callable(visitor) and not hasattr(visitor, "visit_feature"):
            visitor(node)
        else:
            node.accept(visitor)
        yield node


def load_stream(stream) -> list[GenomeNode]:
    """ref: load_stream.c — pull the whole input into memory."""
    return list(stream)


def script_wrapper_stream(stream, next_cb) -> Iterator[GenomeNode]:
    """ref: script_wrapper_stream.c — delegate per-node processing to a
    user callback (the reference wraps Lua functions; the Python
    callback stands in for them). The callback may return a replacement
    node, None to drop the node, or the node itself."""
    for node in stream:
        out = next_cb(node)
        if out is not None:
            yield out


# ---------------------------------------------------------------------------
# feature-index coupling (ref: feature_stream.c, feature_in_stream.c,
# feature_out_stream.c)
# ---------------------------------------------------------------------------

def feature_stream(stream, feature_index) -> Iterator[GenomeNode]:
    """ref: feature_stream.c — pass-through that adds every feature and
    region node to the given FeatureIndex."""
    pending = []
    for node in stream:
        if isinstance(node, (FeatureNode, RegionNode)):
            pending.append(node)
        yield node
    feature_index.add_gff3(pending)


def feature_in_stream(feature_index) -> Iterator[GenomeNode]:
    """ref: feature_in_stream.c — emit the index content as a node
    stream: per seqid one region node (covering the seqid range) then
    its features in position order."""
    for seqid in feature_index.seqids():
        rng = feature_index.range_for_seqid(seqid)
        yield RegionNode(seqid, rng.start, rng.end)
        feats = feature_index.features_for_seqid(seqid)
        feats = sorted(feats, key=lambda f: (f.range.start,
                                             -(f.range.end)))
        yield from feats


def feature_out_stream(stream, feature_index) -> Iterator[GenomeNode]:
    """ref: feature_out_stream.c — synonym family of feature_stream:
    collects the flow into the index while passing nodes through (the
    reference variant defers region creation to the index)."""
    yield from feature_stream(stream, feature_index)


# ---------------------------------------------------------------------------
# region tidying / target selection / CDS check (ref:
# tidy_region_node_stream.c + tidy_region_node_visitor.c,
# targetbest_select_stream.c, cds_check_stream.c)
# ---------------------------------------------------------------------------

def tidy_region_node_stream(stream) -> Iterator[GenomeNode]:
    """ref: tidy_region_node_stream.c — buffer everything; extend each
    sequence-region node to the joined range of its seqid's features
    (the reference's tidy visitor joins every feature tree's range into
    the region's), then replay."""
    nodes = list(stream)
    joined: dict[str, Range] = {}
    for node in nodes:
        if isinstance(node, FeatureNode):
            rng = None
            for f in node.traverse():
                rng = f.range if rng is None else rng.join(f.range)
            if rng is not None:
                prev = joined.get(node.seqid)
                joined[node.seqid] = rng if prev is None \
                    else prev.join(rng)
    for node in nodes:
        if isinstance(node, RegionNode) and node.seqid in joined:
            node.range = node.range.join(joined[node.seqid])
        yield node


def targetbest_select_stream(stream) -> Iterator[GenomeNode]:
    """ref: targetbest_select_stream.c — among features with a
    single-id Target attribute sharing (seqid, target id), keep only
    the best-scored one; everything else passes through. Emission is
    deferred (dlist order: kept features in arrival order)."""
    kept: list = []            # (order marker) arrival-ordered entries
    target_to_idx: dict[tuple, int] = {}
    for node in stream:
        if not isinstance(node, FeatureNode):
            kept.append(node)
            continue
        target = node.get_attribute("Target")
        if not target:
            kept.append(node)
            continue
        ids = target.split()
        # multi-target features pass through unselected
        if len(target.split(",")) > 1:
            kept.append(node)
            continue
        key = (node.seqid, ids[0])
        prev = target_to_idx.get(key)
        if prev is None:
            target_to_idx[key] = len(kept)
            kept.append(node)
        else:
            prev_node = kept[prev]
            if (node.score or 0) > (prev_node.score or 0):
                kept[prev] = node
    yield from kept


def cds_check_stream(stream, tidy: bool = False) -> Iterator[GenomeNode]:
    """ref: cds_check_stream.c / cds_check_visitor.c — verify that the
    CDS features of each gene have consistent phases (phase of the
    next CDS = (3 - (len - phase) % 3) % 3 along the strand); raises
    ValueError (or fixes the phase with tidy=True) on mismatch."""
    for node in stream:
        if isinstance(node, FeatureNode):
            by_parent: dict[int, list[FeatureNode]] = {}
            for f in node.traverse():
                if f.type == "CDS":
                    by_parent.setdefault(
                        id(f.parents[0]) if f.parents else 0,
                        []).append(f)
            for group in by_parent.values():
                group = sorted(group, key=lambda f: f.range.start)
                if group and group[0].strand == "-":
                    group = group[::-1]
                expected = None
                for f in group:
                    phase = int(f.phase) \
                        if str(f.phase) in ("0", "1", "2") else 0
                    if expected is not None and phase != expected:
                        if tidy:
                            f.phase = expected
                            phase = expected
                        else:
                            raise ValueError(
                                f"CDS feature on {f.seqid} "
                                f"{f.range.start}-{f.range.end} has "
                                f"phase {phase}, expected {expected}")
                    expected = (3 - (f.range.length - phase) % 3) % 3
        yield node


def dot_out_stream(stream, out=None) -> Iterator[GenomeNode]:
    """Pass-through stream printing the feature graph as graphviz dot
    (ref: src/extended/dot_out_stream.c over dot_visitor.c: a record
    node per feature labeled with id | type, edges to children)."""
    import sys as _sys
    out = out or _sys.stdout
    print("\ndigraph nodes {", file=out)
    counter = [0]
    ids: dict[int, int] = {}

    def nid(f):
        key = id(f)
        if key not in ids:
            ids[key] = counter[0]
            counter[0] += 1
        return ids[key]

    def walk(f):
        i = nid(f)
        print(f'{i} [shape=record, label="{{ {i} | {f.type} }}"]',
              file=out)
        for c in f.children:
            print(f"{i} -> {nid(c)}", file=out)
            walk(c)

    for node in stream:
        if isinstance(node, FeatureNode):
            walk(node)
        yield node
    print("}", file=out)


def _gff3_feature_lines(node) -> list[str]:
    from .gff3 import GFF3Writer
    w = GFF3Writer()
    w.visit(node)
    return [ln for ln in w.lines if not ln.startswith("#")]


def gff3_linesorted_out_stream(stream, out=None) -> None:
    """Drain the stream and print every GFF3 feature line in full
    lexicographic line order (ref:
    src/extended/gff3_linesorted_out_stream.c: token-pair comparator
    over seqid / source / type / coordinates — a total line sort)."""
    import sys as _sys
    out = out or _sys.stdout
    lines = []
    for node in stream:
        if isinstance(node, FeatureNode):
            lines.extend(_gff3_feature_lines(node))
    for ln in sorted(lines):
        print(ln, file=out)


def gff3_numsorted_out_stream(stream, out=None) -> None:
    """Like gff3_linesorted_out_stream with numeric coordinate order
    within (seqid) groups (ref:
    src/extended/gff3_numsorted_out_stream.c)."""
    import sys as _sys
    out = out or _sys.stdout
    rows = []
    for node in stream:
        if isinstance(node, FeatureNode):
            for ln in _gff3_feature_lines(node):
                c = ln.split("\t")
                rows.append(((c[0], int(c[3]), int(c[4]), ln), ln))
    for _, ln in sorted(rows, key=lambda r: r[0]):
        print(ln, file=out)


def sequence_node_add_stream(stream, seqs: dict[str, str]
                             ) -> Iterator[GenomeNode]:
    """Append one SequenceNode per region referenced by the features,
    taken from `seqs` (ref: src/extended/sequence_node_add_stream.c —
    adds the region sequences ahead of an embedded-FASTA writer)."""
    from .genome_node import SequenceNode
    seen = []
    for node in stream:
        if isinstance(node, FeatureNode) and node.seqid in seqs and \
                node.seqid not in seen:
            seen.append(node.seqid)
        yield node
    for sid in seen:
        yield SequenceNode(sid, seqs[sid])


def sequence_node_out_stream(stream, out=None) -> Iterator[GenomeNode]:
    """Split off SequenceNodes as FASTA on `out`, forward the rest
    (ref: src/extended/sequence_node_out_stream.c)."""
    import sys as _sys
    out = out or _sys.stdout
    for node in stream:
        from .genome_node import SequenceNode
        if isinstance(node, SequenceNode):
            print(f">{node.description}", file=out)
            for i in range(0, len(node.sequence), 80):
                print(node.sequence[i:i + 80], file=out)
        else:
            yield node


def add_ids_stream(stream) -> Iterator[GenomeNode]:
    """Assign fresh IDs to top-level features lacking one
    (ref: src/extended/add_ids_stream.c / id assignment in
    gff3_out: the writer needs IDs to express Parent links)."""
    counter = [0]
    for node in stream:
        if isinstance(node, FeatureNode) and node.children and \
                not node.get_attribute("ID"):
            counter[0] += 1
            node.attributes["ID"] = f"gene{counter[0]}"
        yield node
