"""Sequential suffix-array reader: bounded-memory (suf, lcp) streaming.

The port's copy of ``genometools_tpu/index/seqread.py`` (host numpy),
over the port's ``index/parts.py``. Capability equivalent of the
reference's Sequentialsuffixarrayreader
(ref: src/match/esa-seqread.h:27-42, esa-seqread.c): every bottom-up /
traversal consumer pulls (suftab[i], lcptab[i]) pairs in rank order
without holding whole tables. Three sources:

  * ``from_esa``   — in-memory EnhancedSuffixArray (chunked views);
  * ``from_files`` — stream .suf/.lcp/.llv straight off disk in fixed
    chunks (the reference's SEQ_scan mode: mmap-free, O(chunk) memory);
  * ``from_parts`` — no index on disk at all: drive the memory-bounded
    code-range parts engine (index.parts.iter_suftab_parts) and derive
    the LCP values on the fly, so consumers run on inputs whose suffix
    table never exists in RAM or on disk at once (the `-parts/-memlimit`
    execution model of src/match/sfx-partssuf.c, streamed to consumers).

LCP convention matches the on-disk table: lcp[0] = 0, lcp[i] =
lcp(suffix at rank i-1, suffix at rank i); chunk boundaries carry the
convention seamlessly (the first lcp of a chunk refers to the previous
chunk's last suffix).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np

from ..core.chardef import is_special

CHUNK = 1 << 20


def lcp_pairwise(codes: np.ndarray, a: np.ndarray, b: np.ndarray,
                 sigma: int = 4) -> np.ndarray:
    """Vectorized lcp of suffix pairs (a[i], b[i]) under the canonical
    order contract (special at p == unique key, so lcp stops at the
    first special or mismatch). Wave compare, 8 symbols per round."""
    n = codes.size
    W = 8
    a = np.asarray(a, np.int64).copy()
    b = np.asarray(b, np.int64).copy()
    l = np.zeros(a.size, np.int64)
    alive = np.ones(a.size, bool)
    while alive.any():
        adv = np.zeros(a.size, np.int64)
        still = alive.copy()
        for d in range(W):
            ia = a + l + d
            ib = b + l + d
            ok = still & (ia < n) & (ib < n)
            ca = codes[np.minimum(ia, n - 1)]
            cb = codes[np.minimum(ib, n - 1)]
            same = ok & ~is_special(ca) & ~is_special(cb) & (ca == cb)
            adv += same
            still = same
        l += adv
        alive &= adv == W
    return l


class SequentialSuffixArrayReader:
    """Iterator of (suf int64[], lcp int32[]) chunks in rank order."""

    def __init__(self, gen: Iterator[tuple[np.ndarray, np.ndarray]],
                 total: int):
        self._gen = gen
        self.total = total

    def chunks(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        return self._gen

    # -- sources -----------------------------------------------------------
    @classmethod
    def from_esa(cls, esa, chunk: int = CHUNK):
        assert esa.lcptab is not None
        sa = esa.suftab
        lcp = esa.lcptab

        def gen():
            for s in range(0, sa.size, chunk):
                e = min(sa.size, s + chunk)
                yield (np.asarray(sa[s:e], np.int64),
                       np.asarray(lcp[s:e], np.int32))
        return cls(gen(), int(sa.size))

    @classmethod
    def from_files(cls, indexname: str, chunk: int = CHUNK):
        """Stream .suf/.lcp/.llv off disk (ref: esa-seqread SEQ_scan)."""
        from .esa import read_prj
        prj = read_prj(indexname)
        intsize = int(prj.get("integersize", 64))
        dt = np.uint64 if intsize == 64 else np.uint32
        n1 = int(prj["totallength"]) + 1
        llv_path = Path(indexname + ".llv")
        if llv_path.exists() and llv_path.stat().st_size:
            llv = np.fromfile(llv_path, dtype=dt).reshape(-1, 2)
            ov_idx = llv[:, 0].astype(np.int64)
            ov_val = llv[:, 1].astype(np.int64)
        else:
            ov_idx = np.zeros(0, np.int64)
            ov_val = np.zeros(0, np.int64)

        def gen():
            with open(indexname + ".suf", "rb") as fs, \
                    open(indexname + ".lcp", "rb") as fl:
                done = 0
                while done < n1:
                    m = min(chunk, n1 - done)
                    suf = np.fromfile(fs, dtype=dt, count=m).astype(np.int64)
                    small = np.fromfile(fl, dtype=np.uint8, count=m)
                    lcp = small.astype(np.int32)
                    lo = np.searchsorted(ov_idx, done)
                    hi = np.searchsorted(ov_idx, done + m)
                    if hi > lo:
                        lcp[ov_idx[lo:hi] - done] = ov_val[lo:hi]
                    yield suf, lcp
                    done += m
        return cls(gen(), n1)

    @classmethod
    def from_parts(cls, codes: np.ndarray, max_part_suffixes: int,
                   sigma: int = 4):
        """Stream the parts engine; LCP derived on the fly per part
        (adjacent wave compare) + across part boundaries."""
        from .parts import iter_suftab_parts
        n = codes.size

        def gen():
            prev_last = None
            for part in iter_suftab_parts(codes, max_part_suffixes, sigma):
                if part.size == 0:
                    continue
                lcp = np.zeros(part.size, np.int32)
                if part.size > 1:
                    lcp[1:] = lcp_pairwise(codes, part[:-1], part[1:],
                                           sigma)
                if prev_last is not None:
                    lcp[0] = lcp_pairwise(
                        codes, np.asarray([prev_last]),
                        np.asarray([part[0]]), sigma)[0]
                prev_last = int(part[-1])
                yield part.astype(np.int64), lcp
        return cls(gen(), n + 1)
