"""Script filters: user-supplied node predicates for `select`
(ref: src/extended/script_filter.c + src/tools/gt_scriptfilter.c —
the reference uses Lua scripts with metadata variables and a
filter(gn) function; here the scripts are Python files with the same
contract).

The port's copy of ``genometools_tpu/anno/script_filter.py`` (JAX-free
host code; the port imports nothing of the reference package).

A filter file defines metadata (``name``, ``author``, ``version``,
``email``, ``short_descr``, ``description`` — each either a string or
a zero-argument function, like the reference accepts both) and a
``filter(gn)`` callable; ``filter`` returning True means the node is
FILTERED OUT (the reference's convention)."""

from __future__ import annotations

FIELDS = ("name", "version", "author", "email", "description")


def load_filter(path: str):
    """Returns (metadata dict, predicate)."""
    ns: dict = {}
    exec(compile(open(path).read(), path, "exec"), ns)
    meta = {}
    for f in FIELDS + ("short_descr",):
        v = ns.get(f)
        if callable(v):
            v = v()
        meta[f] = v if v is not None else ""
    pred = ns.get("filter")
    if not callable(pred):
        raise ValueError(f"{path}: no filter(gn) function defined")
    return meta, pred


def show_metadata(meta: dict, scriptname: str | None = None,
                  oneline: bool = False) -> str:
    """The reference's metadata display
    (testdata/script_filter_output.txt):

        filter name:\\t<name>
        version:\\t<version>
        author:\\t\\t<author>
        email:\\t\\t<email>
        description:\\t<description>
    """
    if oneline:
        parts = [f"{meta['name']} {meta['version']} ({meta['author']}, "
                 f"{meta['email']}): {meta['description']}"]
        if scriptname:
            parts.insert(0, scriptname + ":")
        return " ".join(parts)
    out = []
    if scriptname:
        out.append(f"script:\t\t{scriptname}")
    out.append(f"filter name:\t{meta['name']}")
    out.append(f"version:\t{meta['version']}")
    out.append(f"author:\t\t{meta['author']}")
    out.append(f"email:\t\t{meta['email']}")
    out.append(f"description:\t{meta['description']}")
    return "\n".join(out)
