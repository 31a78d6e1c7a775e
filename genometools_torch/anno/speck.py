"""speck: annotation spec checking (ref: src/tools/gt_speck.c +
gtdata/spec — the reference embeds a Lua describe/it/expect DSL).

The port's copy of ``genometools_tpu/anno/speck.py`` (JAX-free
host code; the port imports nothing of the reference package).

Python redesign of the rule engine: a spec file is a Python module
using the same describe/it/expect shapes —

    @feature("gene")
    def _(gene, it):
        it("contains a transcript",
           gene.has_child_of_supertype("transcript"))
        it("appears as a root node", gene.appears_as_root_node())
        it("is not suspiciously short (>30nt)",
           gene.range_length() > 30)

`feature` registers per-type node checks; every matching feature node
runs them; the report lists each failed expectation with the node's
coordinates and a summary (the reference prints per-node failures and
exits non-zero on violations).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .genome_node import FeatureNode

# transcript supertypes mirrored from the SO subset the reference spec
# relies on (full SO reasoning lives in anno_db.TypeChecker)
_SUPERTYPES = {
    "transcript": {"transcript", "mRNA", "ncRNA", "tRNA", "rRNA", "snRNA",
                   "snoRNA", "pseudogenic_transcript", "miRNA"},
}


class SpecNode:
    """The node wrapper exposing the spec-file API (the Lua feature
    node methods the reference specs call)."""

    def __init__(self, node: FeatureNode, roots: set):
        self._n = node
        self._roots = roots

    @property
    def node(self):
        return self._n

    def get_type(self):
        return self._n.type

    def get_range(self):
        return (self._n.range.start, self._n.range.end)

    def range_length(self):
        return self._n.range.end - self._n.range.start + 1

    def get_strand(self):
        return getattr(self._n, "strand", ".")

    def get_seqid(self):
        return self._n.seqid

    def get_attribute(self, key):
        return (self._n.attributes or {}).get(key)

    def appears_as_root_node(self):
        return id(self._n) in self._roots

    def direct_children(self):
        return list(getattr(self._n, "children", []) or [])

    def children(self):
        out = []
        stack = list(self.direct_children())
        while stack:
            c = stack.pop()
            out.append(c)
            stack.extend(getattr(c, "children", []) or [])
        return out

    def children_of_type(self, t):
        return [c for c in self.children() if c.type == t]

    def has_child_of_type(self, t):
        return any(c.type == t for c in self.children())

    def has_child_of_supertype(self, st):
        types = _SUPERTYPES.get(st, {st})
        return any(c.type in types for c in self.children())

    def overlaps_all_children(self):
        r = self._n.range
        return all(c.range.start >= r.start and c.range.end <= r.end
                   for c in self.children())


@dataclass
class SpeckResult:
    checks: int = 0
    failures: list = field(default_factory=list)  # (type, desc, where)

    def report(self) -> str:
        out = []
        for typ, desc, where in self.failures:
            out.append(f'failure: "{typ}" node {where}: {desc}')
        out.append(f"{self.checks} checks, {len(self.failures)} failures")
        return "\n".join(out)


def run_speck(spec_path: str, nodes: list) -> SpeckResult:
    rules: dict[str, list] = {}

    def feature(typ):
        def register(fn):
            rules.setdefault(typ, []).append(fn)
            return fn
        return register

    ns = {"feature": feature}
    code = open(spec_path).read()
    exec(compile(code, spec_path, "exec"), ns)

    roots = {id(n) for n in nodes}
    res = SpeckResult()

    def visit(node):
        if hasattr(node, "type") and node.type in rules:
            wrapper = SpecNode(node, roots)
            where = (f"{node.seqid}:{node.range.start}-"
                     f"{node.range.end}")

            def it(desc, ok):
                res.checks += 1
                if not ok:
                    res.failures.append((node.type, desc, where))

            for fn in rules[node.type]:
                fn(wrapper, it)
        for c in getattr(node, "children", []) or []:
            visit(c)

    for n in nodes:
        visit(n)
    return res
