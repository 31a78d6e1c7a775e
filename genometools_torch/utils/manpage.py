"""Manpage-source generation for the CLI driver.

The port's copy of ``genometools_tpu/utils/manpage.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of `gt -createman <outdir>`
(ref: src/gtr.c:294-357 create_manpage/create_manpages) backed by
gt_option_parser_manpage (ref: src/core/option.c:534-720): for every
registered tool — including nested toolbox subtools — an asciidoc
`.mansrc` file is written to the output directory:

    GENOMETOOLS_TORCH-SUFFIXERATOR(1)
    =================================
    :man source:   GenomeTools-Torch
    ...
    NAME
    ----
    genometools_torch-suffixerator - compute enhanced suffix array
    SYNOPSIS / DESCRIPTION (one `*-opt* ['type']::` block per option,
    with "(default: ...)" tails, option.c:660-668)

The option metadata comes from the live argparse registry, so the
pages can never drift from the actual parser — the same
single-source-of-truth property the reference gets from generating
pages out of its GtOptionParser objects.
"""

from __future__ import annotations

import argparse
import os

from .. import __version__


def _toolname_print(toolname: str, upper: bool) -> str:
    """ref: option.c:488 print_toolname — spaces become dashes."""
    s = toolname.replace(" ", "-")
    return s.upper() if upper else s


def _header(hdr: str) -> str:
    """ref: option.c:479 print_asciidoc_header."""
    return f"{hdr}\n{'-' * len(hdr)}\n\n"


def _value_marker(action: argparse.Action) -> tuple[str, str | None]:
    """(asciidoc value marker, default string) per option type
    (ref: option.c:591-668 type dispatch)."""
    if isinstance(action, (argparse._StoreTrueAction,
                           argparse._StoreFalseAction)):
        return "['yes|no']", "yes" if action.default is True else "no"
    if action.choices:
        d = action.default
        return "['...']", str(d) if d not in (None, "") else "undefined"
    d = action.default
    if action.type in (int, float):
        return "['value']", "undefined" if d is None else str(d)
    metavar = action.metavar if isinstance(action.metavar, str) else ""
    if metavar.lower() in ("file", "filename") or \
            "file" in (action.dest or ""):
        return "['filename']", "undefined" if not d else str(d)
    return "['string']", "undefined" if d in (None, "") else str(d)


def _synopsis(parser: argparse.ArgumentParser) -> str:
    parts = []
    for a in parser._actions:
        if isinstance(a, (argparse._HelpAction,
                          argparse._SubParsersAction)):
            continue
        if a.option_strings:
            name = a.option_strings[0]
            mark = "" if isinstance(
                a, (argparse._StoreTrueAction,
                    argparse._StoreFalseAction)) else " ..."
            parts.append(f"[{name}{mark}]")
        else:
            parts.append(a.dest)
    if any(isinstance(a, argparse._SubParsersAction)
           for a in parser._actions):
        parts.append("[subtool ...]")
    return " ".join(parts) if parts else "[option ...]"


def manpage_source(toolname: str,
                   parser: argparse.ArgumentParser) -> str:
    """One tool's asciidoc man source (ref: option.c:534
    gt_option_parser_manpage)."""
    title = _toolname_print(toolname, True) + "(1)"
    out = [title, "=" * len(title),
           ":man source:   GenomeTools-Torch",
           f":man version:  {__version__}",
           ":man manual:   GenomeTools-Torch Manual", ""]
    one_liner = (parser.description or "").strip() or \
        f"run the {toolname.split()[-1]} tool"
    out.append(_header("NAME") + _toolname_print(toolname, False) +
               f" - {one_liner}\n")
    out.append(_header("SYNOPSIS") +
               f"*{toolname}* {_synopsis(parser)}\n")
    body = []
    for a in parser._actions:
        if isinstance(a, (argparse._HelpAction,
                          argparse._SubParsersAction)):
            continue
        if not a.option_strings:
            continue
        marker, default = _value_marker(a)
        desc = (a.help or "").strip() or a.dest
        tail = f" (default: {default})" if default is not None else ""
        body.append(f"*{a.option_strings[0]}* {marker}::\n"
                    f"{desc}{tail}\n")
    if body:
        out.append(_header("DESCRIPTION") + "\n".join(body))
    out.append(_header("REPORTING BUGS") +
               "Report bugs to the genometools_torch repository.\n")
    return "\n".join(out)


def _iter_tools(parser: argparse.ArgumentParser, prefix: str):
    """(full toolname, subparser) for every tool, recursing into
    nested toolboxes (ref: gt_tool_iterator_new + set_prefix_target,
    gtr.c:342-350)."""
    for action in parser._actions:
        if not isinstance(action, argparse._SubParsersAction):
            continue
        seen = {}
        for name, sp in action.choices.items():
            if id(sp) in seen:       # aliases map to one parser
                continue
            seen[id(sp)] = name
            full = f"{prefix} {name}"
            yield full, sp
            yield from _iter_tools(sp, full)


def create_manpages(parser: argparse.ArgumentParser, outdir: str,
                    prog: str = "genometools_torch") -> int:
    """Write <outdir>/<tool>.mansrc for the driver and every tool;
    returns the file count (ref: gtr.c:325 create_manpages)."""
    os.makedirs(outdir, exist_ok=True)
    count = 0
    for toolname, sp in [(prog, parser)] + list(_iter_tools(parser,
                                                            prog)):
        path = os.path.join(outdir,
                            toolname.replace(" ", "_") + ".mansrc")
        with open(path, "w") as fh:
            fh.write(manpage_source(toolname, sp))
        count += 1
    return count
