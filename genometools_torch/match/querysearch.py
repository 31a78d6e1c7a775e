"""Online query matching over a suffix array, for `repfind -q`.

The port's copy of the first part of
``genometools_tpu/match/querysearch.py``: ``SuffixArraySearcher`` (the
reference's esa-mmsearch machinery, ref: src/match/esa-mmsearch.c:
gt_mmsearch binary search at :116, GtMMsearchiterator :203) and
``query_substring_matches`` (gt_querysubstringmatch). Searches narrow a
suftab interval with numpy searchsorted over the characters at the
current depth. Host code. The module's other tools (genomediff,
uniquesub, matstat, tagerator) are not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..core.chardef import is_special
from ..core.encseq import Encseq
from ..index.esa import EnhancedSuffixArray


class SuffixArraySearcher:
    """Interval-narrowing search over an ESA (the MMsearchiterator role).

    Within a suftab interval whose suffixes share a depth-d prefix, the
    characters at depth d appear in non-decreasing code order (regular
    codes 0..3 first, specials/short suffixes after), so each pattern
    character narrows the interval with two numpy searchsorted calls —
    O(|pattern| log n) total, no Python char loops."""

    def __init__(self, esa: EnhancedSuffixArray):
        self.esa = esa
        self.codes = esa.encseq.codes_view(esa.readmode).astype(np.uint8)
        self.sa = esa.suftab.astype(np.int64)
        self.n = self.codes.size

    def _narrow(self, lo: int, hi: int, depth: int, sym: int):
        """Sub-interval of suffixes whose depth-d char == sym."""
        idx = self.sa[lo:hi] + depth
        chars = np.where(idx < self.n,
                         self.codes[np.minimum(idx, self.n - 1)],
                         np.uint8(255))
        l2 = lo + int(np.searchsorted(chars, sym, "left"))
        h2 = lo + int(np.searchsorted(chars, sym, "right"))
        return l2, h2

    def interval(self, pattern: np.ndarray) -> tuple[int, int]:
        """suftab interval [lo, hi) of suffixes with `pattern` as prefix
        (ref: gt_mmsearch)."""
        lo, hi = 0, len(self.sa)
        for depth, sym in enumerate(pattern):
            if sym >= 250 or lo >= hi:
                return lo, lo
            lo, hi = self._narrow(lo, hi, depth, int(sym))
        return lo, hi

    def occurrences(self, pattern: np.ndarray) -> np.ndarray:
        lo, hi = self.interval(pattern)
        return np.sort(self.sa[lo:hi])

    def longest_prefix_match(self, query: np.ndarray) -> int:
        """Length of the longest prefix of `query` occurring in the
        index (matching statistics primitive, ref: esa-minunique.c)."""
        lo, hi = 0, len(self.sa)
        length = 0
        while length < len(query):
            sym = int(query[length])
            if sym >= 250:
                break
            l2, h2 = self._narrow(lo, hi, length, sym)
            if l2 >= h2:
                break
            lo, hi = l2, h2
            length += 1
        return length


def query_substring_matches(esa: EnhancedSuffixArray, query: Encseq,
                            minlength: int):
    """All maximal substring matches of every query position
    (ref: gt_querysubstringmatch): for each query position, the longest
    prefix of the query suffix occurring in the database; reported when
    >= minlength. Returns rows (dbpos, querypos, length) with all db
    occurrences enumerated."""
    searcher = SuffixArraySearcher(esa)
    qcodes = query.codes_view(0)
    out = []
    qn = qcodes.size
    qpos = 0
    while qpos < qn:
        suffix = qcodes[qpos:]
        if is_special(qcodes[qpos:qpos + 1])[0]:
            qpos += 1
            continue
        length = searcher.longest_prefix_match(suffix)
        if length >= minlength:
            for dbpos in searcher.occurrences(qcodes[qpos:qpos + length]):
                out.append((int(dbpos), qpos, length))
        qpos += 1
    return out
