"""Genome-node object model.

The port's copy of ``genometools_tpu/anno/genome_node.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference GtGenomeNode class hierarchy
(ref: src/extended/genome_node.c, feature_node.c, region_node.c,
comment_node.c, sequence_node.c, meta_node.c, eof_node.c).

Nodes are plain Python objects; the pull-stream pipeline operates on
them (see node_stream.py). Ranges are 1-based inclusive like GFF3.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Range:
    start: int
    end: int

    def __post_init__(self):
        assert self.start <= self.end, f"bad range {self.start}>{self.end}"

    @property
    def length(self) -> int:
        return self.end - self.start + 1

    def overlaps(self, other: "Range") -> bool:
        return self.start <= other.end and other.start <= self.end

    def contains(self, other: "Range") -> bool:
        return self.start <= other.start and other.end <= self.end

    def join(self, other: "Range") -> "Range":
        return Range(min(self.start, other.start), max(self.end, other.end))


class GenomeNode:
    """Base: everything flowing through a node stream."""

    def __init__(self, seqid: str | None = None, rng: Range | None = None):
        self.seqid = seqid
        self.range = rng

    @property
    def start(self):
        return self.range.start if self.range else None

    @property
    def end(self):
        return self.range.end if self.range else None

    def accept(self, visitor):
        raise NotImplementedError


class FeatureNode(GenomeNode):
    """A GFF3 feature line; children via Parent relations
    (ref: src/extended/feature_node.c)."""

    def __init__(self, seqid: str, ftype: str, start: int, end: int,
                 strand: str = ".", source: str = ".", score=None,
                 phase: str = "."):
        super().__init__(seqid, Range(start, end))
        self.type = ftype
        self.source = source
        self.score = score
        self.strand = strand
        self.phase = phase
        self.attributes: dict[str, str] = {}
        self.children: list["FeatureNode"] = []
        self.parents: list["FeatureNode"] = []
        self.is_multi = False
        self.multi_representative: "FeatureNode | None" = None
        self.serial = 0  # document order, set by the parser

    def get_attribute(self, key: str) -> str | None:
        return self.attributes.get(key)

    def set_attribute(self, key: str, value: str) -> None:
        self.attributes[key] = value

    def add_child(self, child: "FeatureNode") -> None:
        self.children.append(child)
        child.parents.append(self)

    def traverse(self):
        """Yield self + all descendants, DFS pre-order, each node once."""
        seen = set()
        stack = [self]
        out = []
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            out.append(n)
            stack.extend(reversed(n.children))
        return out

    def score_is_defined(self) -> bool:
        return self.score is not None

    def accept(self, visitor):
        return visitor.visit_feature(self)


class RegionNode(GenomeNode):
    """##sequence-region directive (ref: region_node.c)."""

    def __init__(self, seqid: str, start: int, end: int):
        super().__init__(seqid, Range(start, end))

    def accept(self, visitor):
        return visitor.visit_region(self)


class CommentNode(GenomeNode):
    def __init__(self, comment: str):
        super().__init__()
        self.comment = comment

    def accept(self, visitor):
        return visitor.visit_comment(self)


class MetaNode(GenomeNode):
    """Any other ##directive (ref: meta_node.c)."""

    def __init__(self, directive: str, data: str):
        super().__init__()
        self.directive = directive
        self.data = data

    def accept(self, visitor):
        return visitor.visit_meta(self)


class SequenceNode(GenomeNode):
    """Inline FASTA from a ##FASTA section (ref: sequence_node.c)."""

    def __init__(self, description: str, sequence: str):
        super().__init__()
        self.description = description
        self.sequence = sequence

    def accept(self, visitor):
        return visitor.visit_sequence(self)


class EOFNode(GenomeNode):
    def accept(self, visitor):
        return visitor.visit_eof(self)


class NodeVisitor:
    """Double-dispatch base (ref: src/extended/node_visitor.c)."""

    def visit_feature(self, node):
        pass

    def visit_region(self, node):
        pass

    def visit_comment(self, node):
        pass

    def visit_meta(self, node):
        pass

    def visit_sequence(self, node):
        pass

    def visit_eof(self, node):
        pass
