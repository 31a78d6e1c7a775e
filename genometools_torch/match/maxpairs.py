"""Maximal repeated pairs: the repfind core engine.

The port's copy of ``genometools_tpu/match/maxpairs.py``: the
reference's gt_enumeratemaxpairs_generic (ref:
src/match/esa-maxpairs.c:477), behind `gt repfind`.

A pair (p1, p2, len) is a maximal repeat iff the substrings of length
``len`` at p1 and p2 are equal and extending left or right breaks
equality (left-maximality: the preceding characters differ or are
special or absent; right-maximality: the following characters differ,
which the walk guarantees by emitting at the exact lcp-interval depth).

The traversal is the native bottom-up stack walk (native/gtnative.cpp
gt_maxpairs) over the (suftab, lcptab) the card built. Without the
native library ``enumerate_maxpairs`` raises; the pure-Python walk
``_maxpairs_py`` is a test oracle only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.chardef import is_special
from ..core.encseq import Encseq
from ..index.esa import EnhancedSuffixArray


def left_context_classes(esa: EnhancedSuffixArray) -> np.ndarray:
    """Class of the character preceding each suffix (uint8 per SA rank):
    0..sigma-1 for regular chars, sigma for position 0 / preceding special
    (the always-left-maximal class)."""
    enc = esa.encseq
    sigma = enc.alphabet.num_chars
    codes = enc.codes_view(esa.readmode)
    # padded[p+1] = codes[p], padded[0] = special sentinel for rank of
    # position 0 — one gather by sa itself (= prev+1), no clip pass
    padded = np.empty(codes.size + 1, np.uint8)
    padded[0] = 254
    padded[1:] = codes
    pv = padded[esa.suftab]
    return np.where(is_special(pv), np.uint8(sigma), pv)


@dataclass
class MaxPairs:
    pos1: np.ndarray
    pos2: np.ndarray
    length: np.ndarray

    @property
    def count(self) -> int:
        return int(self.pos1.size)

    def canonical(self) -> np.ndarray:
        """Sorted (len, min(pos), max(pos)) rows for set comparison."""
        a = np.minimum(self.pos1, self.pos2)
        b = np.maximum(self.pos1, self.pos2)
        rows = np.stack([self.length, a, b], axis=1)
        order = np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))
        return rows[order]


def enumerate_maxpairs_files(indexname: str, enc, searchlength: int
                             ) -> "MaxPairs | None":
    """Maxpairs fed straight from the memmapped index files (.suf u64 +
    .lcp bytes + .llv), context classes derived in the native walker —
    no table conversions, no lcp reconstruction (ref: gt_mapsuffixarray
    + gt_enumeratemaxpairs).  Forward 64-bit indexes only; None when
    the fast path does not apply."""
    from pathlib import Path
    from ..core.native import maxpairs_esa_native
    from ..index.esa import read_prj
    try:
        prj = read_prj(indexname)
    except OSError:
        return None
    if int(prj.get("integersize", 64)) != 64 or \
            int(prj.get("readmode", 0)) != 0:
        return None
    suf_p, lcp_p = Path(indexname + ".suf"), Path(indexname + ".lcp")
    if not suf_p.exists() or not lcp_p.exists():
        return None
    suf = np.memmap(suf_p, dtype=np.uint64, mode="r")
    lcp = np.memmap(lcp_p, dtype=np.uint8, mode="r")
    llv_p = Path(indexname + ".llv")
    llv = np.fromfile(llv_p, np.uint64) \
        if llv_p.exists() and llv_p.stat().st_size else np.zeros(0, np.uint64)
    res = maxpairs_esa_native(enc.codes, suf, lcp, llv, searchlength,
                              enc.alphabet.num_chars)
    if res is None:
        return None
    return MaxPairs(*res)


def enumerate_maxpairs(esa: EnhancedSuffixArray, searchlength: int) -> MaxPairs:
    """All maximal pairs with length >= searchlength."""
    assert esa.lcptab is not None, "maxpairs needs the lcp table"
    cls = left_context_classes(esa)
    sigma = esa.encseq.alphabet.num_chars
    from ..core.native import maxpairs_native
    res = maxpairs_native(esa.suftab, esa.lcptab, cls, searchlength, sigma)
    if res is None:
        raise RuntimeError("the native maximal-pairs walk is unavailable")
    return MaxPairs(*res)


def _maxpairs_py(sa, lcp, cls, searchlength, sigma):
    """Pure-Python mirror of the native stack walk (a test oracle)."""
    n1 = len(sa)
    nclasses = sigma + 1
    p1, p2, ln = [], [], []

    class Node:
        __slots__ = ("depth", "lists")

        def __init__(self, depth):
            self.depth = depth
            self.lists = [[] for _ in range(nclasses)]

    def emit_leaf(node, rank):
        if node.depth < searchlength:
            return
        cb = cls[rank]
        for ca in range(nclasses):
            if ca == cb and ca != sigma:
                continue
            for pa in node.lists[ca]:
                p1.append(pa)
                p2.append(sa[rank])
                ln.append(node.depth)

    def emit_child(node, child):
        if node.depth < searchlength:
            return
        for ca in range(nclasses):
            for cb in range(nclasses):
                if ca == cb and ca != sigma:
                    continue
                for pa in node.lists[ca]:
                    for pb in child.lists[cb]:
                        p1.append(pa)
                        p2.append(pb)
                        ln.append(node.depth)

    def merge(node, child):
        for c in range(nclasses):
            node.lists[c].extend(child.lists[c])

    stack = [Node(0)]
    for i in range(1, n1 + 1):
        l = lcp[i] if i < n1 else 0
        if l > stack[-1].depth:
            fresh = Node(l)
            fresh.lists[cls[i - 1]].append(sa[i - 1])
            stack.append(fresh)
        else:
            emit_leaf(stack[-1], i - 1)
            stack[-1].lists[cls[i - 1]].append(sa[i - 1])
        while l < stack[-1].depth:
            child = stack.pop()
            if l > stack[-1].depth:
                fresh = Node(l)
                merge(fresh, child)
                stack.append(fresh)
                break
            emit_child(stack[-1], child)
            merge(stack[-1], child)
    return (np.asarray(p1, np.int32), np.asarray(p2, np.int32),
            np.asarray(ln, np.int32))


def enumerate_maxpairs_stream(reader, encseq: Encseq, searchlength: int,
                              readmode: int = 0) -> MaxPairs:
    """Maximal pairs from a SequentialSuffixArrayReader — bounded
    memory: only the open >= searchlength intervals' position lists are
    held (ref model: gt_enumeratemaxpairs over a
    Sequentialsuffixarrayreader, src/match/esa-maxpairs.c:477 +
    esa-seqread.h:27). Output identical to enumerate_maxpairs."""
    from ..core.native import MaxpairsStream
    sigma = encseq.alphabet.num_chars
    codes = encseq.codes_view(readmode)
    nc = codes.size
    ms = MaxpairsStream(searchlength, sigma)
    for suf, lcp in reader.chunks():
        prev = suf - 1
        cls = np.full(suf.size, sigma, np.uint8)
        ok = prev >= 0
        pv = codes[np.clip(prev, 0, max(nc - 1, 0))]
        reg = ok & ~is_special(pv)
        cls[reg] = pv[reg]
        ms.feed(suf, lcp, cls)
    return MaxPairs(*ms.finish())
