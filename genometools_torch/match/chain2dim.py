"""Colinear chaining of 2-dimensional matches.

The port's copy of ``genometools_tpu/match/chain2dim.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of `gt chain2dim` (ref: src/match/chain2dim.c):
global and local chaining of match fragments (start1, end1, start2, end2,
weight) in the sense of Abouelhoda & Ohlebusch. Also provides the
weighted longest-increasing-subsequence filter used by seed_extend's
-snd_pass (ref: src/match/weighted_lis_filter.c).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Fragment:
    start1: int
    end1: int
    start2: int
    end2: int
    weight: int


def _colinear(a: Fragment, b: Fragment, overlaps: bool) -> bool:
    """Can fragment b follow a in a chain?"""
    if overlaps:
        return b.start1 > a.start1 and b.start2 > a.start2 and \
            b.end1 > a.end1 and b.end2 > a.end2
    return b.start1 > a.end1 and b.start2 > a.end2


def chain_fragments(fragments: list[Fragment], local: bool = False,
                    gapcost_factor: float = 0.0, overlaps: bool = False
                    ) -> tuple[int, list[int]]:
    """Best chain by dynamic programming over fragments sorted by end1.

    Returns (score, indices of chained fragments in order).
    global mode (default): chain maximizing total weight (minus gap costs
    when gapcost_factor > 0); local mode: best-scoring subchain.
    ref: gt_chain_fastchaining / chain2dim gchain/lchain modes.
    """
    n = len(fragments)
    if n == 0:
        return 0, []
    order = sorted(range(n), key=lambda i: (fragments[i].end1,
                                            fragments[i].end2))
    score = [0.0] * n
    back = [-1] * n
    for oi, i in enumerate(order):
        fi = fragments[i]
        score[i] = fi.weight
        for j in order[:oi]:
            fj = fragments[j]
            if _colinear(fj, fi, overlaps):
                gap = 0.0
                if gapcost_factor:
                    gap = gapcost_factor * (abs((fi.start1 - fj.end1) -
                                                (fi.start2 - fj.end2)))
                cand = score[j] + fi.weight - gap
                if cand > score[i]:
                    score[i] = cand
                    back[i] = j
    besti = int(np.argmax(score))
    chain = []
    i = besti
    while i != -1:
        chain.append(i)
        i = back[i]
    chain.reverse()
    return int(score[besti]), chain


def weighted_lis_filter(starts_a, ends_a, starts_b, ends_b, weights):
    """Keep the subset of matches forming the best weighted colinear
    subsequence (ref: weighted_lis_filter.c, seed_extend -snd_pass).
    Returns sorted indices of the kept matches."""
    frags = [Fragment(int(a), int(ea), int(b), int(eb), int(w))
             for a, ea, b, eb, w in zip(starts_a, ends_a, starts_b, ends_b,
                                        weights)]
    _, chain = chain_fragments(frags, overlaps=True)
    return sorted(chain)
