"""Online query matching over a suffix array: `repfind -q`, `uniquesub`,
`matstat` and `tagerator`.

The port's counterpart of ``genometools_tpu/match/querysearch.py``:
``SuffixArraySearcher`` (the reference's esa-mmsearch machinery, ref:
src/match/esa-mmsearch.c: gt_mmsearch binary search at :116,
GtMMsearchiterator :203), ``query_substring_matches``
(gt_querysubstringmatch), ``minimum_unique_substrings`` and
``matching_statistics``, ``approximate_search`` and
``tagerator_search`` (the reference's tagerator DFS, ref:
src/match/tagerator.c, idx-limdfs.c). Searches narrow a suftab interval by the
characters at the current depth. All three narrow every query
position at once (``narrow_rows``: one vectorised binary search per
depth over all open intervals) and finish an interval of one suffix by
comparing the texts directly; the reference runs the same narrowing one
position at a time, restarting at depth 0 for each prefix length
(uniquesub), so both are linear scans of the whole suffix array per
query position. The tagerator searches walk the reference's DFS and
narrow each node's four children in one ``narrow_rows`` call. The
results are the reference's. Host code; the index comes from the
port's suffixerator.
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

    def children(self, lo: int, hi: int, depth: int):
        """The sub-intervals of [lo, hi) whose depth char is 0, 1, 2 and
        3: two (4,) arrays."""
        four = np.arange(4)
        return self.narrow_rows(np.full(4, lo, np.int64),
                                np.full(4, hi, np.int64),
                                np.full(4, depth, np.int64), four)

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


def approximate_search(esa: EnhancedSuffixArray, pattern: np.ndarray,
                       max_edits: int, best_match_only: bool = False):
    """Approximate tag matching over the index
    (ref: `gt tagerator`, src/match/tagerator.c + idx-limdfs.c: a
    depth-limited DFA walk over the index trie; here a DFS over
    suffix-array intervals carrying a banded edit-distance row).

    Returns rows (dbpos, length, distance): substring occurrences of the
    whole pattern within edit distance <= max_edits. Each (interval,
    depth) node expands per character by narrowing the suftab interval;
    the DP row prunes branches whose minimum exceeds max_edits.
    """
    searcher = SuffixArraySearcher(esa)
    m = len(pattern)
    if m == 0:
        return []
    results = {}
    init = np.arange(m + 1, dtype=np.int64)
    maxdepth = m + max_edits

    def dfs(lo, hi, depth, row):
        if lo >= hi or depth > maxdepth:
            return
        if row[m] <= max_edits:
            dist = int(row[m])
            for pos in searcher.sa[lo:hi]:
                key = (int(pos), depth)
                if key not in results or results[key] > dist:
                    results[key] = dist
        if row.min() > max_edits:
            return
        for sym, (l2, h2) in enumerate(zip(*searcher.children(lo, hi,
                                                              depth))):
            if l2 >= h2:
                continue
            new = np.empty(m + 1, np.int64)
            new[0] = depth + 1
            for j in range(1, m + 1):
                cost = 0 if pattern[j - 1] == sym else 1
                new[j] = min(row[j - 1] + cost, row[j] + 1, new[j - 1] + 1)
            dfs(int(l2), int(h2), depth + 1, new)

    dfs(0, len(searcher.sa), 0, init)
    # keep, per start position, the best (shortest-distance) occurrence
    out = []
    best_per_pos = {}
    for (pos, depth), dist in results.items():
        cur = best_per_pos.get(pos)
        if cur is None or dist < cur[1]:
            best_per_pos[pos] = (depth, dist)
    for pos, (depth, dist) in sorted(best_per_pos.items()):
        out.append((pos, depth, dist))
    if best_match_only and out:
        dmin = min(d for _, _, d in out)
        out = [r for r in out if r[2] == dmin]
    return out


def step_row(row: np.ndarray, sym_matches: np.ndarray) -> np.ndarray:
    """The edit-distance column one text character deeper: new[0] =
    row[0] + 1, new[j] = min(row[j-1] + (0 if the tag's j-th character
    matches else 1), row[j] + 1, new[j-1] + 1)."""
    m = row.size - 1
    new = np.empty(m + 1, np.int64)
    new[0] = row[0] + 1
    cost = 1 - sym_matches.astype(np.int64)
    cand = np.minimum(row[:-1] + cost, row[1:] + 1)
    prev = new[0]
    for j in range(1, m + 1):
        prev = min(int(cand[j - 1]), prev + 1)
        new[j] = prev
    return new


def tagerator_search(esa: EnhancedSuffixArray, tag: np.ndarray,
                     max_edits: int, nowildcards: bool = True):
    """Complete-tag approximate matching with the reference tagerator's
    accept-and-prune semantics (ref: src/match/tagerator.c +
    idx-limdfs.c runlimdfs/esa_splitandprocess): DFS over suffix-array
    intervals carrying a full edit-distance column; a branch ACCEPTS at
    the earliest depth d where the whole tag aligns within
    ``max_edits`` (row[m] <= e) — every position of the interval is
    reported with dblength d — and the branch is pruned there, so an
    exact occurrence shadowed by a shorter accepting prefix is never
    re-reported (matches the reference's output sets).  Suffixes whose
    next character is special continue as per-suffix context walks
    (ref: esa_overcontext) — specials never match a tag character but
    may be absorbed as differences.

    Returns rows (dbpos, dblen, dist) in DFS report order.
    """
    searcher = SuffixArraySearcher(esa)
    m = len(tag)
    out: list[tuple[int, int, int]] = []
    if m == 0:
        return out
    e = int(max_edits)
    init = np.arange(m + 1, dtype=np.int64)
    maxdepth = m + e
    codes = searcher.codes
    n = searcher.n

    def context_walk(pos, depth, row):
        """Per-suffix continuation once off the shared trie (specials
        or singleton intervals)."""
        d = depth
        r = row
        while d <= maxdepth:
            if r[m] <= e:
                out.append((int(pos), d, int(r[m])))
                return
            if r.min() > e:
                return
            idx = pos + d
            if idx >= n:
                return
            cc = int(codes[idx])
            if cc == 255:                # separator ends the context
                return
            r = step_row(r, tag == cc)
            d += 1

    def dfs(lo, hi, depth, row):
        if lo >= hi or depth > maxdepth:
            return
        if row[m] <= e:
            dist = int(row[m])
            for p in searcher.sa[lo:hi]:
                out.append((int(p), depth, dist))
            return                       # accept-and-prune
        if row.min() > e:
            return
        firstspecial = lo
        for sym, (l2, h2) in enumerate(zip(*searcher.children(lo, hi,
                                                              depth))):
            if l2 >= h2:
                continue
            dfs(int(l2), int(h2), depth + 1, step_row(row, tag == sym))
            firstspecial = int(h2)
        if nowildcards:
            return
        # suffixes with a wildcard at this depth: per-suffix context
        # walks (ref: esa_overcontext; only with -withwildcards)
        for b in range(firstspecial, hi):
            p = int(searcher.sa[b])
            idx = p + depth
            if idx >= n:
                continue
            cc = int(codes[idx])
            if cc < 4 or cc == 255:      # covered by a child / separator
                continue
            context_walk(p, depth + 1, step_row(row, tag == cc))

    dfs(0, len(searcher.sa), 0, init)
    return out


def tagerator_batch(tags: list, max_edits: int, children, positions,
                    n1: int) -> list:
    """``tagerator_search`` (nowildcards) for many tags at once: the
    same DFS nodes, visited one depth at a time for every tag together.
    children(lo, hi, depth) gives the four child intervals of each node
    ((N, 4) arrays lo, hi); positions(slots, depth) the text positions
    reported for suftab slots of nodes accepted at that depth; n1 is
    the number of suftab slots. Returns, per tag, its rows (dbpos, dblen,
    dist) in the DFS's report order: a node that accepts reports and is
    not descended, so the reporting nodes' paths are never prefixes of
    one another and the DFS reports them in the lexicographic order of
    their paths, each node's slots in suftab order."""
    e = int(max_edits)
    out = [[] for _ in tags]
    lens = np.asarray([len(t) for t in tags], np.int64)
    for m in np.unique(lens[lens > 0]).tolist():
        idx = np.flatnonzero(lens == m)
        maxdepth = m + e
        P = np.stack([np.asarray(tags[i], np.int64) for i in idx])
        jj = np.arange(m + 1)
        tg = np.arange(idx.size)
        lo = np.zeros(idx.size, np.int64)
        hi = np.full(idx.size, n1, np.int64)
        # each node's path, one symbol a column, zero past its depth
        path = np.zeros((idx.size, maxdepth), np.uint8)
        row = np.tile(jj, (idx.size, 1))
        reps = []
        for d in range(maxdepth + 1):
            if tg.size == 0:
                break
            acc = row[:, m] <= e                 # accept-and-prune
            if acc.any():
                reps.append((tg[acc], path[acc], lo[acc], hi[acc],
                             np.full(int(acc.sum()), d), row[acc, m]))
            keep = ~acc & (row.min(axis=1) <= e)
            tg, lo, hi, path, row = (tg[keep], lo[keep], hi[keep],
                                     path[keep], row[keep])
            if d == maxdepth or tg.size == 0:
                break
            l2, h2 = children(lo, hi, d)
            k, sym = np.nonzero(l2 < h2)
            cost = (P[tg[k]] != sym[:, None]).astype(np.int64)
            r = row[k]
            c = np.concatenate([r[:, :1] + 1,
                                np.minimum(r[:, :-1] + cost, r[:, 1:] + 1)],
                               axis=1)
            row = np.minimum.accumulate(c - jj, axis=1) + jj
            tg, lo, hi = tg[k], l2[k, sym], h2[k, sym]
            path = path[k]
            path[:, d] = sym
        if not reps:
            continue
        t, path, a, b, dd, dist = (np.concatenate(x) for x in zip(*reps))
        # by tag, then by path: its first column is the most significant
        o = np.lexsort(tuple(path[:, ::-1].T) + (t,))
        t, a, b, dd, dist = t[o], a[o], b[o], dd[o], dist[o]
        cnt = b - a
        rep = np.repeat(np.arange(t.size), cnt)
        slots = a[rep] + np.arange(rep.size) - np.repeat(np.cumsum(cnt) - cnt,
                                                         cnt)
        pos = positions(slots, dd[rep])
        rows = list(zip(pos.tolist(), dd[rep].tolist(), dist[rep].tolist()))
        bounds = np.concatenate([[0], np.cumsum(np.bincount(
            t[rep], minlength=idx.size))])
        for j, i in enumerate(idx.tolist()):
            out[i] = rows[bounds[j]:bounds[j + 1]]
    return out


def esa_tagerator_batch(esa: EnhancedSuffixArray, tags: list,
                        max_edits: int) -> list:
    """``tagerator_batch`` over an ESA: each level's children by one
    ``narrow_rows`` call."""
    searcher = SuffixArraySearcher(esa)

    def children(lo, hi, depth):
        n = lo.size
        l2, h2 = searcher.narrow_rows(np.repeat(lo, 4), np.repeat(hi, 4),
                                      np.full(4 * n, depth),
                                      np.tile(np.arange(4), n))
        return l2.reshape(n, 4), h2.reshape(n, 4)

    return tagerator_batch(tags, max_edits, children,
                           lambda slots, d: searcher.sa[slots],
                           searcher.sa.size)
