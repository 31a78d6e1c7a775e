"""Persistent annotation database + SO type checker + SAM iterator.

The port's copy of ``genometools_tpu/anno/anno_db.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalents of:
  * the reference's persistent feature-index backends
    (ref: src/extended/anno_db_gfflike.c, feature_index backends,
    `gt featureindex` / `gt mkfeatureindex`) — implemented over stdlib
    sqlite3;
  * the OBO-driven feature type checker
    (ref: src/extended/type_checker_obo.c, obo_parser.c);
  * SAM text parsing (ref: src/extended/samfile_iterator.c,
    sam_alignment.c — the reference wraps vendored samtools; plain-text
    SAM is parsed natively here, BAM is out of scope without bgzf).
"""

from __future__ import annotations

import sqlite3
from dataclasses import dataclass, field

from .genome_node import FeatureNode, GenomeNode, Range, RegionNode
from .gff3 import GFF3Writer, parse_gff3


class AnnoDB:
    """SQLite-backed feature store with range queries
    (ref: anno_db_gfflike schema: one row per feature line, parent links).
    """

    def __init__(self, path: str = ":memory:"):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(
            """
            CREATE TABLE IF NOT EXISTS features (
              id INTEGER PRIMARY KEY,
              seqid TEXT, source TEXT, type TEXT,
              start INTEGER, end INTEGER,
              score REAL, strand TEXT, phase TEXT,
              attributes TEXT, parent INTEGER
            );
            CREATE INDEX IF NOT EXISTS feat_range
              ON features (seqid, start, end);
            CREATE TABLE IF NOT EXISTS regions (
              seqid TEXT PRIMARY KEY, start INTEGER, end INTEGER);
            """)

    def add_gff3(self, nodes: list[GenomeNode]) -> None:
        cur = self.conn.cursor()

        def insert(node: FeatureNode, parent_id):
            attrs = ";".join(f"{k}={v}" for k, v in node.attributes.items())
            cur.execute(
                "INSERT INTO features (seqid, source, type, start, end, "
                "score, strand, phase, attributes, parent) "
                "VALUES (?,?,?,?,?,?,?,?,?,?)",
                (node.seqid, node.source, node.type, node.range.start,
                 node.range.end, node.score, node.strand, node.phase,
                 attrs, parent_id))
            fid = cur.lastrowid
            for c in node.children:
                insert(c, fid)
            return fid

        for n in nodes:
            if isinstance(n, FeatureNode):
                insert(n, None)
            elif isinstance(n, RegionNode):
                cur.execute("INSERT OR REPLACE INTO regions VALUES (?,?,?)",
                            (n.seqid, n.range.start, n.range.end))
        self.conn.commit()

    def seqids(self) -> list[str]:
        return [r[0] for r in self.conn.execute(
            "SELECT DISTINCT seqid FROM features ORDER BY seqid")]

    def features_for_range(self, seqid: str, start: int, end: int
                           ) -> list[FeatureNode]:
        rows = self.conn.execute(
            "SELECT seqid, source, type, start, end, score, strand, phase, "
            "attributes, id FROM features WHERE seqid=? AND start<=? AND "
            "end>=? AND parent IS NULL ORDER BY start",
            (seqid, end, start)).fetchall()
        return [self._row_to_feature(r) for r in rows]

    def _row_to_feature(self, row) -> FeatureNode:
        seqid, source, ftype, start, end, score, strand, phase, attrs, fid \
            = row
        f = FeatureNode(seqid, ftype, start, end, strand, source, score,
                        phase)
        for part in (attrs or "").split(";"):
            if "=" in part:
                k, _, v = part.partition("=")
                f.set_attribute(k, v)
        for crow in self.conn.execute(
                "SELECT seqid, source, type, start, end, score, strand, "
                "phase, attributes, id FROM features WHERE parent=? "
                "ORDER BY start", (fid,)):
            f.add_child(self._row_to_feature(crow))
        return f


# ---------------------------------------------------------------------------
# OBO parsing + type checking
# ---------------------------------------------------------------------------

@dataclass
class OBOTerm:
    term_id: str
    name: str
    is_a: list[str] = field(default_factory=list)
    is_obsolete: bool = False


def parse_obo(text: str) -> dict[str, OBOTerm]:
    """Minimal OBO flat-file parser (ref: src/extended/obo_parser.c)."""
    terms: dict[str, OBOTerm] = {}
    cur: OBOTerm | None = None
    in_term = False
    for line in text.splitlines():
        line = line.strip()
        if line == "[Term]":
            in_term = True
            cur = OBOTerm("", "")
            continue
        if line.startswith("["):
            in_term = False
            cur = None
            continue
        if not in_term or cur is None or not line or line.startswith("!"):
            continue
        if ":" not in line:
            continue
        key, _, val = line.partition(":")
        val = val.split("!")[0].strip()
        if key == "id":
            cur.term_id = val
            terms[val] = cur
        elif key == "name":
            cur.name = val
        elif key == "is_a":
            cur.is_a.append(val.split()[0])
        elif key == "is_obsolete" and val == "true":
            cur.is_obsolete = True
    return terms


class TypeChecker:
    """SO-based feature-type validation
    (ref: src/extended/type_checker_obo.c)."""

    def __init__(self, terms: dict[str, OBOTerm]):
        self.terms = terms
        self._by_name = {t.name: t for t in terms.values()
                         if not t.is_obsolete}

    @classmethod
    def from_obo(cls, text: str) -> "TypeChecker":
        return cls(parse_obo(text))

    def is_valid(self, type_name: str) -> bool:
        return type_name in self._by_name or type_name in self.terms

    def is_a(self, type_name: str, ancestor: str) -> bool:
        """Does `type_name` descend from `ancestor` via is_a links?"""
        t = self._by_name.get(type_name) or self.terms.get(type_name)
        anc = self._by_name.get(ancestor) or self.terms.get(ancestor)
        if t is None or anc is None:
            return False
        seen = set()
        stack = [t]
        while stack:
            cur = stack.pop()
            if cur.term_id == anc.term_id:
                return True
            if cur.term_id in seen:
                continue
            seen.add(cur.term_id)
            stack.extend(self.terms[p] for p in cur.is_a if p in self.terms)
        return False

    def check_nodes(self, nodes: list[GenomeNode]) -> list[str]:
        bad = []
        for n in nodes:
            if isinstance(n, FeatureNode):
                for m in n.traverse():
                    if not self.is_valid(m.type):
                        bad.append(m.type)
        return bad


# ---------------------------------------------------------------------------
# SAM parsing
# ---------------------------------------------------------------------------

@dataclass
class SamAlignment:
    qname: str
    flag: int
    rname: str
    pos: int
    mapq: int
    cigar: str
    seq: str

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 4)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 16)

    def cigar_ops(self) -> list[tuple[int, str]]:
        out = []
        num = ""
        for ch in self.cigar:
            if ch.isdigit():
                num += ch
            else:
                out.append((int(num), ch))
                num = ""
        return out

    @property
    def reference_length(self) -> int:
        return sum(c for c, op in self.cigar_ops() if op in "MDN=X")


def parse_bam(path: str):
    """Iterate SamAlignment records from a BAM file (BGZF gzip; see
    assembly/hop.py alignments_from_bam for the record layout)."""
    from ..assembly.hop import alignments_from_bam
    for qname, flag, rname, pos, mapq, cigar, seq, _qual in \
            alignments_from_bam(path):
        yield SamAlignment(qname, flag, rname, pos, mapq, cigar, seq)


def parse_sam(text: str):
    """Iterate SamAlignment records from SAM text
    (ref: samfile_iterator.c)."""
    for line in text.splitlines():
        if not line or line.startswith("@"):
            continue
        f = line.split("\t")
        if len(f) < 11:
            continue
        yield SamAlignment(f[0], int(f[1]), f[2], int(f[3]), int(f[4]),
                           f[5], f[9])
