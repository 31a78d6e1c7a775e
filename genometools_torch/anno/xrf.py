"""XRF abbreviation files + cross-reference checking.

The port's copy of ``genometools_tpu/anno/xrf.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference XRF stack (ref:
src/extended/xrf_abbr_parse_tree.c, xrf_abbr_entry.c,
src/extended/xrf_checker.c) behind `gff3 -xrfcheck`: parse a
GO-registry-style ``.xrf_abbr`` abbreviation definition file and
validate ``Dbxref`` / ``Ontology_term`` attribute values
(``DB:localid[,DB:localid...]``) against it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

_VALID_LABELS = {
    "abbreviation", "shorthand_name", "database", "object", "synonym",
    "example_id", "local_id_syntax", "generic_url", "url_syntax",
    "url_example", "is_obsolete", "consider", "replaced_by",
}


class XRFError(ValueError):
    pass


@dataclass
class XRFAbbrEntry:
    """One abbreviation stanza: label -> values (labels may repeat;
    get() returns the first, ref: xrf_abbr_entry.c gt_xrf_abbr_entry_
    get_value)."""
    filename: str
    line: int
    values: dict[str, list[str]] = field(default_factory=dict)

    def add(self, label: str, value: str) -> None:
        self.values.setdefault(label, []).append(value)

    def get(self, label: str) -> str | None:
        v = self.values.get(label)
        return v[0] if v else None


def parse_xrf_abbr(text: str, filename: str = "<xrf>") -> list[XRFAbbrEntry]:
    """Parse + validate an abbreviation definition file (ref:
    xrf_abbr_parse_tree.c: '!' comments, blank-line-separated stanzas of
    'label: value' lines; unknown labels warn and are skipped; entries
    must carry a unique abbreviation; shorthand_name < 10 chars;
    local_id_syntax must be a valid regex)."""
    entries: list[XRFAbbrEntry] = []
    cur: XRFAbbrEntry | None = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip("\n")
        if line.startswith("!"):
            continue
        if not line.strip():
            if cur is not None and cur.values:
                entries.append(cur)
            cur = None
            continue
        if ":" not in line:
            raise XRFError(
                f'file "{filename}": line {lineno}: missing colon in '
                f'"{line}"')
        label, _, value = line.partition(":")
        label = label.strip()
        value = value.strip()
        if label not in _VALID_LABELS:
            continue                      # reference warns and skips
        if cur is None:
            cur = XRFAbbrEntry(filename, lineno)
        cur.add(label, value)
    if cur is not None and cur.values:
        entries.append(cur)

    seen: set[str] = set()
    for e in entries:
        abbr = e.get("abbreviation")
        if abbr is None:
            raise XRFError(
                f'file "{e.filename}": line {e.line}: required label '
                f'"abbreviation" missing')
        if abbr in seen:
            raise XRFError(
                f'file "{e.filename}": line {e.line}: duplicate '
                f'abbreviation "{abbr}", must be unique')
        seen.add(abbr)
        sh = e.get("shorthand_name")
        if sh is not None and len(sh) >= 10:
            raise XRFError(
                f'file "{e.filename}": line {e.line}: length of '
                f'shorthand name "{sh}" exceeds 10 characters')
        rx = e.get("local_id_syntax")
        if rx is not None:
            try:
                re.compile(rx)
            except re.error:
                raise XRFError(
                    f'file "{e.filename}": line {e.line}: invalid '
                    f'regular expression "{rx}"') from None
    return entries


class XRFChecker:
    """ref: src/extended/xrf_checker.c gt_xrf_checker_new/is_valid."""

    def __init__(self, entries: list[XRFAbbrEntry]):
        self.abbrvs: dict[str, XRFAbbrEntry] = {}
        for e in entries:
            self.abbrvs[e.get("abbreviation")] = e
            syn = e.get("synonym")
            if syn:
                self.abbrvs[syn] = e

    @classmethod
    def from_file(cls, path: str) -> "XRFChecker":
        with open(path) as f:
            return cls(parse_xrf_abbr(f.read(), path))

    def check(self, value: str) -> None:
        """Raise XRFError on the first invalid token (reference error
        texts verbatim, ref: xrf_checker.c:62-99)."""
        for token in value.split(","):
            if ":" not in token:
                raise XRFError(
                    f'xref "{value}": separator colon missing')
            dbid, _, localid = token.partition(":")
            if not localid:
                raise XRFError(
                    f'xref "{value}": local ID (part after colon) '
                    f'missing')
            e = self.abbrvs.get(dbid)
            if e is None:
                raise XRFError(
                    f'xref "{value}": unknown database abbreviation '
                    f'"{dbid}"')
            rx = e.get("local_id_syntax")
            if rx is not None and re.search(rx, localid) is None:
                raise XRFError(
                    f'xref "{value}": local ID "{localid}" does not '
                    f'conform to syntax "{rx}" for the {dbid} database')

    def check_nodes(self, nodes) -> None:
        """Validate Dbxref / Ontology_term of every feature node (ref:
        gff3_parser.c:1389-1394 attribute hook)."""
        from .genome_node import FeatureNode
        for n in nodes:
            if not isinstance(n, FeatureNode):
                continue
            for node in n.traverse():
                for tag in ("Dbxref", "Ontology_term"):
                    v = node.attributes.get(tag)
                    if v is not None:
                        self.check(v)


def resolve_xrf_path(arg: str | None) -> str:
    """Resolution order of `-xrfcheck [arg]` (ref: xrfcheck_info.c):
    no arg -> GO.xrf_abbr from the data dir; arg that is an existing
    file -> itself; otherwise <datadir>/xrf_abbr/<arg>.xrf_abbr. The
    data dirs are $GT_DATA_PATH's, then the checkout's ``gtdata/``
    (where gt keeps its own)."""
    import os
    candidates = []
    datadirs = [d for d in os.environ.get("GT_DATA_PATH", "").split(":")
                if d]
    datadirs.append(os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "gtdata"))
    if arg:
        candidates.append(arg)
        for d in datadirs:
            candidates.append(os.path.join(d, "xrf_abbr",
                                           arg + ".xrf_abbr"))
    else:
        for d in datadirs:
            candidates.append(os.path.join(d, "xrf_abbr", "GO.xrf_abbr"))
    for c in candidates:
        if os.path.exists(c):
            return c
    raise XRFError(f"cannot find XRF abbreviation file for "
                   f"{arg or 'GO'!r}")
