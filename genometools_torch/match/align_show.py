"""Alignment pretty-printing (the reference's 80-column show format).

The port's copy of ``genometools_tpu/match/align_show.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of gt_alignment_show
(ref: src/extended/alignment.c show; used by `gt dev linspace_align` and
seed_extend's -a output): three rows per 80-column block — top sequence,
midline ('|' exact match, ' ' otherwise), bottom sequence, '-' for gaps.

Validated against testdata/gt_linspace_align_global_test_*.out.
"""

from __future__ import annotations

from .alignment import AlignmentResult


def alignment_show(u: str, v: str, result: AlignmentResult,
                   width: int = 80) -> str:
    top = []
    mid = []
    bot = []
    ui, vi = result.ustart, result.vstart
    for op, c in result.eops:
        for _ in range(c):
            if op == "M":
                a, b = u[ui], v[vi]
                top.append(a)
                bot.append(b)
                mid.append("|" if a.lower() == b.lower() and
                           a.lower() in "acgtu" or
                           (a.lower() == b.lower() and a.isalpha() and
                            a.lower() not in "nswyrkvbdhm") else " ")
                ui += 1
                vi += 1
            elif op == "D":
                top.append(u[ui])
                mid.append(" ")
                bot.append("-")
                ui += 1
            else:
                top.append("-")
                mid.append(" ")
                bot.append(v[vi])
                vi += 1
    lines = []
    n = len(top)
    for off in range(0, max(n, 1), width):
        if n == 0:
            break
        lines.append("".join(top[off:off + width]))
        lines.append("".join(mid[off:off + width]))
        lines.append("".join(bot[off:off + width]))
    return "\n".join(lines) + ("\n" if lines else "")


def linspace_align_files(useqs: list[str], vseqs: list[str],
                         mode: str = "global",
                         costs=(0, 1, 1)) -> str:
    """`gt dev linspace_align -ff f1 f2` equivalent: align every sequence
    pair (u, v), print '######' before each alignment."""
    from ..core.alphabet import dna_alphabet
    from .alignment import global_alignment, local_alignment
    alpha = dna_alphabet()
    out = []
    for us in useqs:
        for vs in vseqs:
            out.append("######")
            uc = alpha.encode(us.encode())
            vc = alpha.encode(vs.encode())
            if mode == "global":
                m, mis, gap = costs
                r = global_alignment(uc, vc, -m, -mis, -gap)
            else:
                r = local_alignment(uc, vc)
            out.append(alignment_show(us, vs, r).rstrip("\n"))
    # the reference appends one footer when wildcards occurred anywhere
    wild = set("nswyrkvbdhm")
    if any(ch in wild
           for s in list(useqs) + list(vseqs) for ch in s.lower()):
        out.append("# wildcards are represented by n")
    return "\n".join(out) + "\n"
