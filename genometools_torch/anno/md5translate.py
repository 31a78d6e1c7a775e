"""MD5 seqid translation (gt id_to_md5 / gt md5_to_id).

The port's copy of ``genometools_tpu/anno/md5translate.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference visitors
(ref: src/extended/id_to_md5_visitor.c, md5_to_id_visitor.c) and the
description-grep region mapping (ref: src/core/bioseq_col.c:56 grep_desc,
src/extended/regular_seqid.c gt_regular_seqid_save).

MD5 seqid format (ref: src/extended/md5_seqid.h): "md5:<32 hex>:<id>".
The fingerprint is the md5 of the UPPERCASED sequence. The reverse
translation strips the 37-char prefix when the original id is embedded
("new" format) and falls back to a sequence-collection lookup for the
old format without the embedded id.
"""

from __future__ import annotations

import hashlib
import re

MD5_PREFIX = "md5:"
MD5_TOTAL_LEN = len(MD5_PREFIX) + 32 + 1  # "md5:" + hex + ":"

_SKIP_PREFIXES = ("gi|", "SQ;", "(gi|", "ref|")


def regular_seqid(description: str) -> str:
    """ref: gt_regular_seqid_save — skip db prefix, cut at :|<tab><space>."""
    i = 0
    for p in _SKIP_PREFIXES:
        if description.startswith(p):
            i = len(p)
            break
    out = []
    for cc in description[i:]:
        if cc in ":|\t ":
            break
        out.append(cc)
    return "".join(out)


class SeqCollection:
    """Sequence files + description matching (ref: GtBioseqCol)."""

    def __init__(self, files: list[str], matchdesc: bool = False):
        from ..core.seqio import read_seqfiles
        s = read_seqfiles(files)
        self.descs = list(s.descs)
        self.seqs = [x.tobytes().decode("latin-1") for x in s.seqs]
        self.md5s = [hashlib.md5(x.upper().encode("latin-1")).hexdigest()
                     for x in self.seqs]
        self.matchdesc = matchdesc
        self._cache: dict[str, int] = {}

    def lookup(self, seqid: str) -> int:
        """Index of the sequence a GFF3 seqid refers to."""
        if seqid in self._cache:
            return self._cache[seqid]
        if self.matchdesc:
            # substring grep of the escaped seqid over descriptions
            # (ref: bioseq_col.c grep_desc, matchdescstart=false)
            pat = re.compile(re.escape(seqid))
            hits = [i for i, d in enumerate(self.descs) if pat.search(d)]
        else:
            hits = [i for i, d in enumerate(self.descs)
                    if regular_seqid(d) == seqid]
        if len(hits) > 1:
            raise ValueError(f"query seqid '{seqid}' could match more than "
                             f"one sequence description")
        if not hits:
            raise ValueError(f"no description matched sequence ID '{seqid}'")
        self._cache[seqid] = hits[0]
        return hits[0]

    def md5_for(self, seqid: str) -> str:
        return self.md5s[self.lookup(seqid)]

    def seqid_for_md5(self, md5: str) -> str:
        for i, m in enumerate(self.md5s):
            if m == md5:
                return regular_seqid(self.descs[i])
        raise ValueError(f"no sequence with fingerprint '{md5}' found")


def _split_targets(target: str) -> list[list[str]]:
    return [t.split(" ") for t in target.split(",")]


def _join_targets(parts: list[list[str]]) -> str:
    return ",".join(" ".join(p) for p in parts)


def id_to_md5_nodes(nodes, seqcol: SeqCollection,
                    subtargetids: bool = True):
    """Translate seqids (and Target ids) to md5:<hex>:<id> form."""
    from .genome_node import FeatureNode, RegionNode

    def new_id(seqid: str) -> str:
        if seqid.startswith(MD5_PREFIX):
            return seqid
        return MD5_PREFIX + seqcol.md5_for(seqid) + ":" + seqid

    for node in nodes:
        if isinstance(node, RegionNode):
            node.seqid = new_id(node.seqid)
        elif isinstance(node, FeatureNode):
            for n in node.traverse():
                n.seqid = new_id(n.seqid)
                target = n.get_attribute("Target")
                if target and subtargetids:
                    parts = _split_targets(target)
                    for p in parts:
                        p[0] = new_id(p[0])
                    n.set_attribute("Target", _join_targets(parts))
        yield node


def md5_to_id_nodes(nodes, seqcol: SeqCollection | None = None):
    """Strip md5: prefixes back to regular seqids."""
    from .genome_node import FeatureNode, RegionNode

    def new_id(seqid: str) -> str:
        if not seqid.startswith(MD5_PREFIX):
            return seqid
        if len(seqid) > MD5_TOTAL_LEN:
            return seqid[MD5_TOTAL_LEN:]
        if seqcol is None:
            raise ValueError("no region mapping defined")
        return seqcol.seqid_for_md5(seqid[len(MD5_PREFIX):len(MD5_PREFIX)
                                          + 32])

    for node in nodes:
        if isinstance(node, RegionNode):
            node.seqid = new_id(node.seqid)
        elif isinstance(node, FeatureNode):
            for n in node.traverse():
                n.seqid = new_id(n.seqid)
                target = n.get_attribute("Target")
                if target:
                    parts = _split_targets(target)
                    for p in parts:
                        p[0] = new_id(p[0])
                    n.set_attribute("Target", _join_targets(parts))
        yield node


def parse_lua_mapping(path: str, global_name: str) -> dict[str, str]:
    """Parse a Lua table mapping file of the form
    ``name = { key = "value", ["key"] = "value", ... }``
    (ref: src/extended/mapping.c — the reference runs real Lua; the
    subset used by mapping files is a literal table)."""
    text = open(path).read()
    m = re.search(re.escape(global_name) + r"\s*=\s*\{", text)
    if not m:
        raise ValueError(f"'{global_name}' is not defined in \"{path}\"")
    body_start = m.end()
    depth = 1
    i = body_start
    while i < len(text) and depth:
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
        i += 1
    body = text[body_start:i - 1]
    mapping: dict[str, str] = {}
    for km, kb, val in re.findall(
            r'(?:\["([^"]+)"\]|([A-Za-z_][A-Za-z0-9_]*))\s*=\s*"([^"]*)"',
            body):
        mapping[km or kb] = val
    return mapping
