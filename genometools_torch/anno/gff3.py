"""GFF3 parsing and output.

The port's copy of ``genometools_tpu/anno/gff3.py`` (JAX-free host
code): the parser and writer ltrharvest, tirvish and ltrclustering use.

Capability equivalent of the reference GFF3 machinery
(ref: src/extended/gff3_parser.c (~3k LoC), gff3_visitor.c,
gff3_in_stream.c, gff3_out_stream_api.c).

Parser: full GFF3 — directives (##gff-version, ##sequence-region, other
##meta), comments, attribute escaping (%XX), ID/Parent feature graphs
with multi-parent features, multi-line features (same ID => multi
feature), ### separators, embedded ##FASTA section, '>' shortcut.

Output: reference-compatible rendering — ID regeneration per type
(gene00001 -> gene1, counters per type in order of first output,
ref: gff3_visitor.c), ID first then Parent then other attributes, '###'
separator after every top-level feature group.
"""

from __future__ import annotations

import urllib.parse

from .genome_node import (CommentNode, FeatureNode, GenomeNode, MetaNode,
                          Range, RegionNode, SequenceNode)

GFF_VERSION = "3"


class GFF3Error(ValueError):
    pass


def _unescape(s: str) -> str:
    return urllib.parse.unquote(s) if "%" in s else s


def _escape_attr(s: str) -> str:
    # the reference escapes control chars, %, ; and = but leaves commas
    # (ref: Target lists in U89959_csas.gff3)
    out = []
    for ch in s:
        if ch in "=;&\t\n%" or ord(ch) < 0x20:
            out.append("%%%02X" % ord(ch))
        else:
            out.append(ch)
    return "".join(out)


def parse_attributes(s: str, line_no: int = 0) -> dict[str, str]:
    attrs = {}
    if s in (".", ""):
        return attrs
    for part in s.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise GFF3Error(f'line {line_no}: attribute "{part}" lacks "="')
        key, _, val = part.partition("=")
        key = key.strip()
        if not key:
            raise GFF3Error(f"line {line_no}: empty attribute key")
        if key in attrs:
            raise GFF3Error(f'line {line_no}: duplicate attribute "{key}"')
        attrs[key] = val
    return attrs


def parse_gff3(text: str, checkids: bool = False,
               strict: bool = True) -> list[GenomeNode]:
    """Parse a GFF3 document into top-level nodes in document order.

    Feature graphs are linked via Parent; only top-level features (no
    parents) appear in the returned list (their subtrees hang off
    .children) — the reference's in-stream delivers the same shape.
    """
    # the reference's line reader discards a final line that is not
    # newline-terminated (ref: core/str.c:268 gt_str_read_next_line
    # returns EOF without delivering the partial buffer)
    if text and not text.endswith(("\n", "\r")):
        text = text[:text.rfind("\n") + 1]
    nodes: list[GenomeNode] = []
    id_map: dict[str, FeatureNode] = {}
    regions: dict[str, RegionNode] = {}
    serial = 0
    in_fasta = False
    fasta_desc = None
    fasta_seq: list[str] = []

    def flush_fasta():
        nonlocal fasta_desc, fasta_seq
        if fasta_desc is not None:
            nodes.append(SequenceNode(fasta_desc, "".join(fasta_seq)))
        fasta_desc, fasta_seq = None, []

    orphans: list[tuple[FeatureNode, str, int]] = []

    def resolve_orphans():
        # Parent may be defined later within the same '###' block; the
        # reference resolves such orphans when the block closes
        # (ref: gff3_parser.c process_orphans / orphanage)
        for node, pid, line_no in orphans:
            parent = id_map.get(pid)
            if parent is None:
                raise GFF3Error(
                    f'line {line_no}: Parent "{pid}" was not defined')
            parent.add_child(node)
        orphans.clear()

    def close_region(hard: bool):
        # '###': forget IDs seen so far (features are complete)
        resolve_orphans()
        if hard:
            id_map.clear()

    for line_no, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip("\n")
        if in_fasta:
            if line.startswith(">"):
                flush_fasta()
                fasta_desc = line[1:]
            elif line.strip():
                fasta_seq.append(line.strip())
            continue
        if not line.strip():
            continue
        if line.startswith("###"):
            close_region(True)
            continue
        if line.startswith("##"):
            if line.startswith("##gff-version"):
                ver = line.split()[-1] if len(line.split()) > 1 else ""
                if strict and ver and not ver.startswith("3"):
                    raise GFF3Error(f"line {line_no}: unsupported gff "
                                    f"version {ver}")
            elif line.startswith("##sequence-region"):
                parts = line.split()
                if len(parts) != 4:
                    raise GFF3Error(f"line {line_no}: malformed "
                                    "##sequence-region")
                try:
                    start, end = int(parts[2]), int(parts[3])
                except ValueError as exc:
                    raise GFF3Error(f"line {line_no}: {exc}") from None
                if start > end:
                    raise GFF3Error(f"line {line_no}: region start > end")
                region = RegionNode(parts[1], start, end)
                regions[parts[1]] = region
                nodes.append(region)
            elif line.startswith("##FASTA"):
                in_fasta = True
            else:
                d = line[2:].split(None, 1)
                nodes.append(MetaNode(d[0] if d else "",
                                      d[1] if len(d) > 1 else ""))
            continue
        if line.startswith("#"):
            nodes.append(CommentNode(line[1:]))
            continue
        if line.startswith(">"):
            in_fasta = True
            fasta_desc = line[1:]
            continue

        cols = line.split("\t")
        if len(cols) != 9:
            if strict:
                # message wording follows the reference parser
                raise GFF3Error(f"line {line_no} does not contain 9 tab (\\t) "
                                f"separated fields")
            continue
        seqid, source, ftype, start_s, end_s, score_s, strand, phase, attrs_s \
            = cols
        try:
            start, end = int(start_s), int(end_s)
        except ValueError:
            raise GFF3Error(f"line {line_no}: non-numeric range") from None
        if start > end:
            raise GFF3Error(f"line {line_no}: start {start} > end {end}")
        if strand not in "+-.?":
            raise GFF3Error(f"line {line_no}: invalid strand {strand!r}")
        if phase not in (".", "0", "1", "2"):
            raise GFF3Error(f"line {line_no}: invalid phase {phase!r}")
        score = None if score_s == "." else float(score_s)
        attrs = parse_attributes(attrs_s, line_no)

        fid = attrs.get("ID")
        parents = attrs.get("Parent")
        node = FeatureNode(_unescape(seqid), ftype, start, end, strand,
                           _unescape(source), score, phase)
        serial += 1
        node.serial = serial
        node.line_number = line_no
        node.attributes = {k: _unescape(v) for k, v in attrs.items()}
        # declared sequence-regions must contain their features
        # (ref: gff3_parser.c "is not contained in sequence region" check)
        reg = regions.get(node.seqid)
        if strict and reg is not None and not reg.range.contains(node.range):
            raise GFF3Error(
                f"line {line_no}: sequence region {node.seqid} "
                f"({reg.range.start}, {reg.range.end}) does not contain "
                f"feature range ({start}, {end})")
        if fid and fid in id_map:
            # multi-line feature: same ID => multi-feature group
            rep = id_map[fid]
            node.is_multi = True
            rep.is_multi = True
            node.multi_representative = rep
        elif fid:
            id_map[fid] = node
        if parents:
            for pid in parents.split(","):
                parent = id_map.get(pid)
                if parent is None:
                    # forward reference: defer to the end of the block
                    orphans.append((node, pid, line_no))
                else:
                    parent.add_child(node)
        else:
            nodes.append(node)

    flush_fasta()
    resolve_orphans()
    check_cds_phases(nodes, tidy=not strict)
    return add_missing_regions(nodes, set(regions))


def check_cds_phases(nodes: list[GenomeNode], tidy: bool = False,
                     filename: str = "input") -> None:
    """Validate (or, with tidy, fix) CDS phases per parent feature
    (ref: src/extended/cds_check_visitor.c check_cds_phases; wired into
    every GFF3 in-stream via cds_check_stream, gff3_in_stream.c).

    Non-multi CDS children of one parent form one chain; multi-features
    (shared ID) are grouped by representative.  Reverse-strand chains
    are checked in transcript order.  A CDS reachable from multiple
    parents that needs different phases is split per parent in tidy
    mode (ref: split_cds_feature) and an error otherwise.
    """
    import warnings

    def check_group(group: list[FeatureNode], is_multi: bool,
                    seen: set[int], to_split: dict) -> None:
        if group and group[0].strand == "-":
            group = group[::-1]
        correct = 0
        first = True
        total = 0
        for i, fn in enumerate(group):
            ph = fn.phase
            ln = getattr(fn, "line_number", 0)
            if (i == 0 and ph == ".") or (i and ph != str(correct)):
                if id(fn) in seen:
                    # CDS with multiple parents requiring different
                    # phases: split it per parent in tidy mode
                    if tidy and not is_multi and not fn.children:
                        warnings.warn(
                            f'CDS feature on line {ln} in file '
                            f'"{filename}" has multiple parents which '
                            f"require different phases; split feature")
                        to_split[id(fn)] = fn
                    else:
                        raise GFF3Error(
                            f'CDS feature on line {ln} in file '
                            f'"{filename}" has multiple parents which '
                            f"require different phases")
                elif tidy:
                    warnings.warn(
                        f'CDS feature on line {ln} in file "{filename}" '
                        f"has the wrong phase {ph} -> correcting it to "
                        f"{correct}")
                    fn.phase = str(correct)
                else:
                    raise GFF3Error(
                        f'CDS feature on line {ln} in file "{filename}" '
                        f"has the wrong phase {ph} (should be {correct})")
            length = fn.range.length
            if first:
                cur_phase = int(fn.phase) if fn.phase in "012" else 0
                if length >= cur_phase:
                    # 5' partial genes: skip the phase bases
                    first = False
                    total = length - cur_phase
                    correct = (3 - total % 3) % 3
                else:
                    # corner case: first CDS shorter than its phase
                    correct = 1
            else:
                total += length
                correct = (3 - total % 3) % 3
            seen.add(id(fn))

    def run_pass(top: FeatureNode, to_split: dict) -> None:
        seen: set[int] = set()
        for parent in top.traverse():
            kids = sorted(
                (c for c in parent.children if c.type == "CDS"),
                key=lambda c: (c.range.start, c.range.end, c.serial))
            if not kids:
                continue
            plain = [c for c in kids if not c.is_multi]
            if plain:
                check_group(plain, False, seen, to_split)
            multi: dict[int, list[FeatureNode]] = {}
            for c in kids:
                if c.is_multi:
                    rep = c.multi_representative or c
                    multi.setdefault(id(rep), []).append(c)
            for group in multi.values():
                check_group(group, True, seen, to_split)

    def split(top: FeatureNode, fn: FeatureNode) -> None:
        """Give every parent its own copy; the first (tree-order) parent
        keeps the original (ref: cds_check_visitor.c split_cds_feature).
        """
        parents = [p for p in top.traverse() if fn in p.children]
        for p in parents[1:]:
            c = FeatureNode(fn.seqid, fn.type, fn.range.start,
                            fn.range.end, fn.strand, fn.source, fn.score,
                            fn.phase)
            c.attributes = dict(fn.attributes)
            c.serial = fn.serial
            c.line_number = getattr(fn, "line_number", 0)
            p.children[p.children.index(fn)] = c
            c.parents = [p]
            fn.parents.remove(p)

    for top in nodes:
        if not isinstance(top, FeatureNode):
            continue
        while True:
            to_split: dict = {}
            run_pass(top, to_split)
            if not to_split:
                break
            for fn in to_split.values():
                split(top, fn)


def add_missing_regions(nodes: list[GenomeNode],
                        have: set | None = None) -> list[GenomeNode]:
    """Synthesize ##sequence-region directives for seqids that lack one,
    placed before the first feature of that seqid
    (ref: gff3 in-stream region creation, gt_gff3_prob_10.out)."""
    if have is None:
        have = {n.seqid for n in nodes if isinstance(n, RegionNode)}
    span: dict[str, Range] = {}
    for n in nodes:
        if isinstance(n, FeatureNode) and n.seqid not in have:
            for m in n.traverse():
                r = span.get(n.seqid)
                span[n.seqid] = m.range if r is None else r.join(m.range)
    out: list[GenomeNode] = []
    emitted = set()
    for n in nodes:
        if isinstance(n, FeatureNode) and n.seqid in span and \
                n.seqid not in emitted:
            out.append(RegionNode(n.seqid, span[n.seqid].start,
                                  span[n.seqid].end))
            emitted.add(n.seqid)
        out.append(n)
    return out


# ---------------------------------------------------------------------------
# output
# ---------------------------------------------------------------------------

class GFF3Writer:
    """Render nodes back to GFF3 text (ref: gff3_visitor.c).

    retainids=False regenerates feature IDs as <type><N> with per-type
    counters, assigning IDs only to features that have children or are
    multi-features.
    """

    def __init__(self, retainids: bool = False, fasta_width: int = 80):
        self.retainids = retainids
        self.fasta_width = fasta_width
        self._type_counters: dict[str, int] = {}
        self._ids: dict[int, str] = {}
        self.lines: list[str] = []
        self._version_written = False
        self._had_fasta = False

    def _write_version(self):
        if not self._version_written:
            self.lines.append(f"##gff-version {GFF_VERSION}")
            self._version_written = True

    def _alloc_id(self, node: FeatureNode) -> str:
        if id(node) in self._ids:
            return self._ids[id(node)]
        if self.retainids and node.get_attribute("ID"):
            new = node.get_attribute("ID")
        else:
            n = self._type_counters.get(node.type, 0) + 1
            self._type_counters[node.type] = n
            new = f"{node.type}{n}"
        self._ids[id(node)] = new
        return new

    def _attr_string(self, node: FeatureNode, parent_ids: list[str]) -> str:
        parts = []
        needs_id = bool(node.children) or node.is_multi or \
            (self.retainids and node.get_attribute("ID") is not None)
        if needs_id and node.multi_representative is None:
            parts.append("ID=" + _escape_attr(self._alloc_id(node)))
        elif node.multi_representative is not None:
            parts.append(
                "ID=" + _escape_attr(self._alloc_id(node.multi_representative)))
        if parent_ids:
            parts.append("Parent=" + ",".join(map(_escape_attr, parent_ids)))
        for k, v in node.attributes.items():
            if k in ("ID", "Parent"):
                continue
            parts.append(f"{k}={_escape_attr(v)}")
        return ";".join(parts) if parts else "."

    def _feature_line(self, node: FeatureNode, parent_ids: list[str]) -> str:
        # reference renders scores with %.3g (ref: gff3_visitor.c)
        score = "." if node.score is None else f"{node.score:.3g}"
        return "\t".join([
            node.seqid, node.source, node.type, str(node.range.start),
            str(node.range.end), score, node.strand, node.phase,
            self._attr_string(node, parent_ids)])

    def visit_feature_tree(self, top: FeatureNode):
        self._write_version()
        # Emission order (matches reference outputs, see
        # standard_gene_as_dag_sorted.gff3): DFS pre-order where every
        # node hangs under its LAST parent in document order — i.e. a
        # multi-parent feature prints only after all its parents — and
        # siblings print in document order.
        attach_children: dict[int, list[FeatureNode]] = {}
        all_nodes = top.traverse()
        for n in all_nodes:
            if n is top:
                continue
            attach = max(n.parents, key=lambda p: p.serial)
            attach_children.setdefault(id(attach), []).append(n)
        for lst in attach_children.values():
            # siblings sort by (start, end), ties in document order
            # (ref: standard_gene_as_dag_sorted.gff3)
            lst.sort(key=lambda n: (n.range.start, n.range.end, n.serial))
        order: list[FeatureNode] = []
        stack = [top]
        while stack:
            n = stack.pop()
            order.append(n)
            stack.extend(reversed(attach_children.get(id(n), [])))
        emitted_id = False
        for n in order:
            # Parent ids render in the parents' document order
            # (ref: gt_gff3_addintrons_overlapping_exons golden)
            pids = [self._alloc_id(p)
                    for p in sorted(n.parents, key=lambda q: q.serial)]
            if pids or n.children or n.is_multi:
                emitted_id = True
            self.lines.append(self._feature_line(n, pids))
        # '###' delimits the ID scope; only needed when IDs were emitted
        if emitted_id:
            self.lines.append("###")

    def visit(self, node: GenomeNode):
        if isinstance(node, FeatureNode):
            self.visit_feature_tree(node)
        elif isinstance(node, RegionNode):
            self._write_version()
            self.lines.append(f"##sequence-region   {node.seqid} "
                              f"{node.range.start} {node.range.end}")
        elif isinstance(node, CommentNode):
            self._write_version()
            self.lines.append("#" + node.comment)
        elif isinstance(node, MetaNode):
            self._write_version()
            self.lines.append(f"##{node.directive} {node.data}".rstrip())
        elif isinstance(node, SequenceNode):
            self._write_version()
            if not self._had_fasta:
                self.lines.append("##FASTA")
                self._had_fasta = True
            self.lines.append(">" + node.description)
            for i in range(0, len(node.sequence), self.fasta_width):
                self.lines.append(node.sequence[i:i + self.fasta_width])

    def render(self, nodes) -> str:
        for n in nodes:
            self.visit(n)
        self._write_version()
        return "\n".join(self.lines) + "\n"


def gff3_to_string(nodes, retainids: bool = False) -> str:
    return GFF3Writer(retainids=retainids).render(nodes)
