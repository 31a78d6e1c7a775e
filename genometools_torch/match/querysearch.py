"""Online query matching over a suffix array: `repfind -q`, `uniquesub`
and `matstat`.

The port's counterpart of ``genometools_tpu/match/querysearch.py``:
``SuffixArraySearcher`` (the reference's esa-mmsearch machinery, ref:
src/match/esa-mmsearch.c: gt_mmsearch binary search at :116,
GtMMsearchiterator :203), ``query_substring_matches``
(gt_querysubstringmatch), ``minimum_unique_substrings`` and
``matching_statistics``. Searches narrow a suftab interval by the
characters at the current depth. All three narrow every query
position at once (``narrow_rows``: one vectorised binary search per
depth over all open intervals) and finish an interval of one suffix by
comparing the texts directly; the reference runs the same narrowing one
position at a time, restarting at depth 0 for each prefix length
(uniquesub), so both are linear scans of the whole suffix array per
query position. The results are the reference's. Host code; the index
comes from the port's suffixerator. Tagerator's searches are not
ported yet.
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
    codes 0..3 first, specials/short suffixes after), so each query
    character narrows the interval by two binary searches, run for many
    query positions at once (``narrow_rows``)."""

    def __init__(self, esa: EnhancedSuffixArray):
        self.esa = esa
        self.codes = esa.encseq.codes_view(esa.readmode).astype(np.uint8)
        self.sa = esa.suftab.astype(np.int64)
        self.n = self.codes.size

    def char_at(self, x: np.ndarray, depth) -> np.ndarray:
        """The depth-`depth` character of the suffixes at suftab slots x
        (255 past the text's end)."""
        idx = self.sa[x] + depth
        return np.where(idx < self.n, self.codes[np.minimum(idx, self.n - 1)],
                        np.uint8(255))

    def _bound(self, lo, hi, depth, sym, right: bool) -> np.ndarray:
        """Per row, the first slot in [lo, hi) whose depth char is >= sym
        (> sym if right)."""
        a, b = lo.copy(), hi.copy()
        act = np.flatnonzero(a < b)
        while act.size:
            m = (a[act] + b[act]) >> 1
            c = self.char_at(m, depth[act])
            go = c <= sym[act] if right else c < sym[act]
            a[act] = np.where(go, m + 1, a[act])
            b[act] = np.where(go, b[act], m)
            act = act[a[act] < b[act]]
        return a

    def narrow_rows(self, lo: np.ndarray, hi: np.ndarray, depth: np.ndarray,
                    sym: np.ndarray):
        """Per row, the sub-interval of [lo, hi) whose depth char equals
        sym."""
        l2 = self._bound(lo, hi, depth, sym, right=False)
        return l2, self._bound(l2, hi, depth, sym, right=True)

    def common_run(self, qcodes: np.ndarray, qi: np.ndarray,
                   ti: np.ndarray) -> np.ndarray:
        """Per row, how far qcodes[qi:] and the text at ti agree, as the
        narrowing would find it: a query character >= 250 or the query's
        end stops the run, and no text special matches."""
        qn = qcodes.size
        run = np.zeros(qi.size, np.int64)
        act = np.arange(qi.size)
        steps = np.arange(64)
        while act.size:
            q = qi[act, None] + run[act, None] + steps
            t = ti[act, None] + run[act, None] + steps
            qc = qcodes[np.minimum(q, qn - 1)]
            tc = self.codes[np.minimum(t, self.n - 1)]
            same = (q < qn) & (qc < 250) & (t < self.n) & (tc == qc)
            k = np.where(same.all(axis=1), 64, np.argmin(same, axis=1))
            run[act] += k
            act = act[k == 64]
        return run


def query_substring_matches(esa: EnhancedSuffixArray, query: Encseq,
                            minlength: int):
    """All maximal substring matches of every query position
    (ref: gt_querysubstringmatch): for each query position, the longest
    prefix of the query suffix occurring in the database; reported when
    >= minlength. Returns rows (dbpos, querypos, length) with all db
    occurrences enumerated, by query position, then db position."""
    rows, length, lo, hi = _match_intervals(SuffixArraySearcher(esa),
                                            query.codes_view(0))
    hit = length >= minlength
    rows, length, lo, cnt = rows[hit], length[hit], lo[hit], (hi - lo)[hit]
    rep = np.repeat(np.arange(rows.size), cnt)
    slot = lo[rep] + np.arange(rep.size) - np.repeat(np.cumsum(cnt) - cnt,
                                                     cnt)
    db = esa.suftab[slot].astype(np.int64)
    o = np.lexsort((db, rep))
    return [(int(d), int(q), int(L)) for d, q, L in
            zip(db[o], rows[rep[o]], length[rep[o]])]


def minimum_unique_substrings(esa: EnhancedSuffixArray, query: Encseq,
                              minlength: int = 1,
                              maxlength: int | None = None):
    """`gt uniquesub` (ref: esa-minunique.c gt_findminuniquesubstrings):
    for each query position, the shortest prefix length that is unique
    in the database (occurs 0 times as an extension = unique point);
    reported if within [minlength, maxlength]. Rows (qpos, length)."""
    searcher = SuffixArraySearcher(esa)
    qcodes = query.codes_view(0)
    qn = qcodes.size
    rows = np.flatnonzero(~is_special(qcodes))
    top = qn - rows
    if maxlength:
        top = np.minimum(top, maxlength)
    found = np.zeros(rows.size, np.int64)
    lo = np.zeros(rows.size, np.int64)
    hi = np.full(rows.size, searcher.sa.size, np.int64)
    act = np.arange(rows.size)
    depth = 0
    while act.size:
        # prefix length depth + 1: a special or a character >= 250 ends
        # the search with no unique prefix
        act = act[depth < top[act]]
        sym = qcodes[rows[act] + depth]
        act, sym = act[sym < 250], sym[sym < 250]
        l2, h2 = searcher.narrow_rows(lo[act], hi[act],
                                      np.full(act.size, depth), sym)
        found[act[h2 - l2 == 1]] = depth + 1
        keep = h2 - l2 > 1
        act = act[keep]
        lo[act], hi[act] = l2[keep], h2[keep]
        depth += 1
    hit = (found > 0) & (found >= minlength)
    return [(int(q), int(f)) for q, f in zip(rows[hit], found[hit])]


def matching_statistics(esa: EnhancedSuffixArray, query: Encseq):
    """`gt matstat`: per query position the length of the longest match
    starting there (ref: matching statistics over the index)."""
    qcodes = query.codes_view(0)
    out = np.zeros(qcodes.size, np.int64)
    rows, length, _, _ = _match_intervals(SuffixArraySearcher(esa), qcodes)
    out[rows] = length
    return out


def _match_intervals(searcher: SuffixArraySearcher, qcodes: np.ndarray):
    """For every query position that is no special: the length of the
    longest prefix of the query suffix occurring in the index, and the
    suftab interval [lo, hi) of that prefix. Rows (positions, length, lo,
    hi); a character >= 250 ends a match."""
    qn = qcodes.size
    rows = np.flatnonzero(~is_special(qcodes))
    length = np.zeros(rows.size, np.int64)
    lo = np.zeros(rows.size, np.int64)
    hi = np.full(rows.size, searcher.sa.size, np.int64)
    act = np.arange(rows.size)
    depth = 0
    while act.size:
        qi = rows[act] + depth
        act, qi = act[qi < qn], qi[qi < qn]
        sym = qcodes[qi]
        act, qi, sym = act[sym < 250], qi[sym < 250], sym[sym < 250]
        l2, h2 = searcher.narrow_rows(lo[act], hi[act],
                                      np.full(act.size, depth), sym)
        keep = l2 < h2
        act, qi = act[keep], qi[keep]
        lo[act], hi[act] = l2[keep], h2[keep]
        length[act] = depth + 1
        # one suffix left: the rest of the match is a direct comparison
        one = hi[act] - lo[act] == 1
        s = act[one]
        if s.size:
            length[s] += searcher.common_run(
                qcodes, qi[one] + 1, searcher.sa[lo[s]] + depth + 1)
        act = act[~one]
        depth += 1
    return rows, length, lo, hi
