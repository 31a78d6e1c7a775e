"""FM-index: BWT-based compressed full-text index.

The port's counterpart of ``genometools_tpu/index/fmindex.py``:
``FMIndex`` and ``pck_tagerator_search`` are copies of the reference's
host code; ``build_fmindex`` sorts on the card (``build_esa``),
``fmindex_from_codes`` takes the native SA-IS or, without it, the
port's ``build_suffix_array`` on its device; ``FMDeviceRank`` (jitted
XLA in the reference) is torch ops on the device.

Capability equivalent of the reference packedindex / BWTSeq stack
(ref: src/match/eis-bwtseq.c, eis-blockcomp.c, eis-bwtseq-construct.c,
`gt packedindex mkindex` and the legacy fmindex src/match/fmi-*).

Redesign: instead of block-composition encoding, the occ function is a
sampled checkpoint matrix plus a vectorized partial count — the natural
array layout for numpy and the device (rank = checkpoint[c, pos/k] +
count(bwt[k*(pos/k):pos] == c)), and locate uses a sampled suffix array
with LF-walks. Functionally covers: exact backward search (count),
locate, and sequence context regeneration (extract).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

import torch

from ..core.chardef import is_special
from ..core.encseq import FWD, Encseq
from ..core.native import sais_native
from ..device import resolve_device
from ..match.querysearch import step_row, tagerator_batch
from ..ops.bits import M32, from_i32_bits, popcount32
from .esa import EnhancedSuffixArray, build_esa
from .suffix import build_suffix_array


@dataclass
class FMIndex:
    bwt: np.ndarray            # uint8[n+1], 255 = sentinel/special
    counts_less: np.ndarray    # int64[sigma+2]: C array over code order
    occ_checkpoints: np.ndarray  # int64[sigma, nblocks]
    sa_samples: np.ndarray     # int64[ceil((n+1)/s)] suffix positions
    sample_rate: int
    block_size: int
    sigma: int = 4

    # -- construction ------------------------------------------------------
    @classmethod
    def from_esa(cls, esa: EnhancedSuffixArray, block_size: int = 128,
                 sample_rate: int = 32) -> "FMIndex":
        bwt = esa.bwt()
        n1 = bwt.size
        sigma = esa.encseq.alphabet.num_chars
        # treat every special/sentinel BWT byte as one class 'sigma'
        sym = np.where(bwt >= 250, sigma, bwt).astype(np.int64)
        counts = np.bincount(sym, minlength=sigma + 1)
        counts_less = np.zeros(sigma + 2, np.int64)
        np.cumsum(counts, out=counts_less[1:])
        nblocks = (n1 + block_size - 1) // block_size
        occ = np.zeros((sigma, nblocks + 1), np.int64)
        for c in range(sigma):
            hits = (sym == c).astype(np.int64)
            block_sums = np.add.reduceat(
                hits, np.arange(0, n1, block_size))
            occ[c, 1:] = np.cumsum(block_sums)
        sa = esa.suftab.astype(np.int64)
        samples = sa[::sample_rate].copy()
        return cls(bwt, counts_less, occ[:, :-1], samples, sample_rate,
                   block_size, sigma)

    # -- rank --------------------------------------------------------------
    def occ(self, c: int, pos: int) -> int:
        """# occurrences of regular code c in bwt[0:pos]. pos = n + 1 at
        a block boundary is the total (the reference indexes one
        checkpoint past the end there; ROADMAP, Queue 3)."""
        b = pos // self.block_size
        if b == self.occ_checkpoints.shape[1]:
            return int(self.counts_less[c + 1] - self.counts_less[c])
        base = int(self.occ_checkpoints[c, b])
        lo = b * self.block_size
        return base + int(np.count_nonzero(self.bwt[lo:pos] == c))

    # -- backward search ---------------------------------------------------
    def backward_search(self, pattern: np.ndarray) -> tuple[int, int]:
        """suftab interval [lo, hi) of `pattern` (ref: gt_packedindexmstatsforward
        / BWT backward search)."""
        lo, hi = 0, self.bwt.size
        for sym in pattern[::-1]:
            c = int(sym)
            if c >= self.sigma:
                return 0, 0
            lo = int(self.counts_less[c]) + self.occ(c, lo)
            hi = int(self.counts_less[c]) + self.occ(c, hi)
            if lo >= hi:
                return lo, lo
        return lo, hi

    def count(self, pattern: np.ndarray) -> int:
        lo, hi = self.backward_search(pattern)
        return hi - lo

    # -- locate ------------------------------------------------------------
    def _lf(self, rank: int) -> int:
        c = int(self.bwt[rank])
        if c >= 250:
            # specials/sentinel: not tracked; fall back below
            return -1
        return int(self.counts_less[c]) + self.occ(c, rank)

    def locate(self, pattern: np.ndarray, esa_sa: np.ndarray | None = None
               ) -> np.ndarray:
        """Positions of all occurrences. Walks LF to the nearest sampled
        rank; ranks whose walk hits an untracked special fall back to the
        provided plain suftab if given."""
        lo, hi = self.backward_search(pattern)
        out = []
        for rank in range(lo, hi):
            r = rank
            steps = 0
            while r % self.sample_rate != 0:
                nxt = self._lf(r)
                if nxt < 0:
                    break
                r = nxt
                steps += 1
            if r % self.sample_rate == 0:
                out.append(int(self.sa_samples[r // self.sample_rate]) + steps)
            elif esa_sa is not None:
                out.append(int(esa_sa[rank]))
        return np.sort(np.asarray(out, np.int64))

    # -- persistence -------------------------------------------------------
    def save(self, indexname: str) -> None:
        np.savez_compressed(indexname + ".fmi",
                            bwt=self.bwt, counts_less=self.counts_less,
                            occ=self.occ_checkpoints,
                            sa_samples=self.sa_samples)
        Path(indexname + ".fmi.json").write_text(json.dumps({
            "sample_rate": self.sample_rate, "block_size": self.block_size,
            "sigma": self.sigma}))

    @classmethod
    def load(cls, indexname: str) -> "FMIndex":
        d = np.load(indexname + ".fmi.npz")
        meta = json.loads(Path(indexname + ".fmi.json").read_text())
        return cls(d["bwt"], d["counts_less"], d["occ"], d["sa_samples"],
                   meta["sample_rate"], meta["block_size"], meta["sigma"])


def build_fmindex(encseq: Encseq, device="cuda", **kw) -> FMIndex:
    """`gt packedindex mkindex` equivalent; the suffix sort runs on
    `device`."""
    esa = build_esa(encseq, FWD, with_lcp=False, device=device)
    return FMIndex.from_esa(esa, **kw)


# ---------------------------------------------------------------------------
# construction straight from codes (SA-IS; no doubling engine needed) and
# device-batched rank/search — the packedindex depth layer
# (ref: src/match/eis-blockcomp.c block-encoded rank, eis-bwtseq.c)
# ---------------------------------------------------------------------------

def fmindex_from_codes(codes: np.ndarray, sigma: int = 4,
                       block_size: int = 128, sample_rate: int = 32,
                       device="cuda") -> FMIndex:
    """Build an FMIndex over raw uint8 codes via the linear-time SA-IS
    constructor (native; without it the port's suffix sort on `device`),
    including the sentinel suffix — so intervals match the ESA searcher
    exactly.  Keeps `codes` on the index for special-context walks
    (tagerator) and extraction."""
    n = codes.size
    keys = np.where(is_special(codes),
                    sigma + np.arange(n, dtype=np.int64),
                    codes.astype(np.int64))
    keys = np.concatenate([keys, [sigma + n]])
    if keys[-1] < 2 ** 31 - 1:
        sa = sais_native(keys.astype(np.int32))
        if sa is None:
            sa, _ = build_suffix_array(keys.astype(np.int32),
                                       with_lcp=False,
                                       device=resolve_device(device))
            sa = sa.cpu().numpy()
        sa = sa.astype(np.int64)
    else:
        raise NotImplementedError("fmindex >2^31: use index.parts")
    n1 = sa.size
    prev = sa - 1
    bwt = np.where(prev >= 0, codes[np.maximum(prev, 0)],
                   np.uint8(255)).astype(np.uint8)
    sym = np.where(bwt >= 250, sigma, bwt).astype(np.int64)
    # specials in the BWT are one class for occ, but locate needs their
    # LF — handled by the sampled-SA fallback walk
    counts = np.bincount(sym, minlength=sigma + 1)
    counts_less = np.zeros(sigma + 2, np.int64)
    np.cumsum(counts, out=counts_less[1:])
    nblocks = (n1 + block_size - 1) // block_size
    occ = np.zeros((sigma, nblocks + 1), np.int64)
    for c in range(sigma):
        hits = (sym == c).astype(np.int64)
        block_sums = np.add.reduceat(hits, np.arange(0, n1, block_size))
        occ[c, 1:] = np.cumsum(block_sums)
    samples = sa[::sample_rate].copy()
    fm = FMIndex(bwt, counts_less, occ[:, :-1], samples, sample_rate,
                 block_size, sigma)
    fm.codes = codes
    fm.sa_full = sa          # retained for locate fallback/verification
    return fm


class FMDeviceRank:
    """Device-resident batched rank/backward-search over an FMIndex:
    the BWT travels as one-hot bitplanes (int32 words) plus the
    checkpoint matrix; occ(c, pos) for a whole batch of (c, pos) lanes
    is a gather of checkpoints + a masked popcount over one block
    (``ops/bits.py::popcount32``: torch has no popcount operator) —
    vectorized across lanes (the device analog of the reference's
    block-compressed rank, eis-blockcomp.c). The checkpoints carry one
    more column, the totals, and the planes one more block of zero
    words, so that pos = n + 1 at a block boundary needs no clamp."""

    def __init__(self, fm: FMIndex, device="cuda"):
        dev = resolve_device(device)
        self.fm = fm
        n1 = fm.bwt.size
        self.n1 = n1
        bs = fm.block_size
        assert bs % 32 == 0
        self.wpb = bs // 32                      # words per block
        nblocks = (n1 + bs - 1) // bs
        npad = (nblocks + 1) * bs
        sym = np.where(fm.bwt >= 250, fm.sigma, fm.bwt).astype(np.uint8)
        sympad = np.full(npad, fm.sigma, np.uint8)
        sympad[:n1] = sym
        planes = [np.packbits(sympad == c, bitorder="little").view(np.int32)
                  for c in range(fm.sigma)]
        self.planes = torch.from_numpy(np.stack(planes)).to(dev)
        totals = np.diff(fm.counts_less[:fm.sigma + 1])[:, None]
        self.ckpt = torch.from_numpy(np.concatenate(
            [fm.occ_checkpoints, totals], axis=1).astype(np.int32)).to(dev)
        self.counts_less = torch.from_numpy(
            fm.counts_less.astype(np.int32)).to(dev)
        self.words = torch.arange(self.wpb, dtype=torch.int64, device=dev)
        self.device = dev

    def occ_batch(self, c: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """int32[len] occurrences of code c[i] in bwt[0:pos[i]]."""
        c, pos = c.long(), pos.long()
        bs = self.fm.block_size
        b = pos // bs
        base = self.ckpt[c, b]
        r = pos - b * bs
        w = from_i32_bits(self.planes[c[:, None], (b * self.wpb)[:, None]
                                      + self.words[None, :]])
        nbits = (r[:, None] - self.words[None, :] * 32).clamp(0, 32)
        mask = torch.where(nbits >= 32, M32, (1 << nbits.clamp(0, 31)) - 1)
        return base + popcount32(w & mask).sum(dim=1).to(torch.int32)

    def backward_search_batch(self, patterns: np.ndarray):
        """suftab intervals of a (B, m) uint8 pattern batch (255-padded
        on the LEFT for shorter patterns): one step of batched occ per
        pattern column, right to left — count for thousands of tags per
        call. Returns int32 (lo, hi) numpy arrays."""
        pats = torch.from_numpy(np.ascontiguousarray(patterns, np.uint8)
                                ).to(self.device).long()
        pats = torch.where(pats == 255, -1, pats)
        B = pats.shape[0]
        lo = torch.zeros(B, dtype=torch.int32, device=self.device)
        hi = torch.full((B,), self.n1, dtype=torch.int32, device=self.device)
        for col in range(pats.shape[1] - 1, -1, -1):
            syms = pats[:, col]
            valid = (syms >= 0) & (syms < self.fm.sigma) & (lo < hi)
            c = syms.clamp(min=0, max=self.fm.sigma - 1)
            nlo = self.counts_less[c] + self.occ_batch(c, lo)
            nhi = self.counts_less[c] + self.occ_batch(c, hi)
            lo = torch.where(valid, nlo, torch.where(syms >= 0, hi, lo))
            hi = torch.where(valid, nhi, hi)
        return lo.cpu().numpy(), hi.cpu().numpy()


def prebwt_bounds(fm: FMIndex, maxdepth: int, device="cuda") -> dict:
    """`gt prebwt`'s bucket boundaries: for every code of depth 1 ..
    maxdepth (digits 0..3, in itertools.product order), its interval
    [lo, hi) where it is not empty. All 4^d codes of a depth go through
    one ``FMDeviceRank.backward_search_batch`` on `device`, where the
    reference searches one code at a time."""
    import itertools
    bounds = {}
    rank = FMDeviceRank(fm, device)
    for depth in range(1, maxdepth + 1):
        codes = np.asarray(list(itertools.product(range(4), repeat=depth)),
                           np.uint8).reshape(-1, depth)
        lo, hi = rank.backward_search_batch(codes)
        for c, a, b in zip(codes, lo.tolist(), hi.tolist()):
            if b > a:
                bounds["".join(map(str, c.tolist()))] = [int(a), int(b)]
    return bounds


def pck_tagerator_search(fm_rev: FMIndex, tag: np.ndarray, max_edits: int,
                         totallength: int, nowildcards: bool = True):
    """tagerator DFS over the packed index: the index is built over the
    REVERSED codes (like `gt packedindex mkindex -dir rev`), so
    extending the tag path on the right is one backward-search step
    (ref: pck_splitandprocess, idx-limdfs.c); a reported occurrence at
    reverse-position q with depth d maps to forward start
    totallength - (q + d) (ref: gen_pck_overinterval, idx-limdfs.c:440).
    Special-context continuation walks locate the (few) suffixes whose
    next char is special and continue on the raw codes.
    Returns (dbpos, dblen, dist) rows; the match set equals
    querysearch.tagerator_search over the forward ESA."""
    m = len(tag)
    out = []
    if m == 0:
        return out
    e = int(max_edits)
    maxdepth = m + e
    init = np.arange(m + 1, dtype=np.int64)
    rcodes = fm_rev.codes
    n = rcodes.size

    def locate_all(lo, hi):
        return [int(fm_rev.sa_full[r]) for r in range(lo, hi)]

    def context_walk(q, depth, row):
        d, r = depth, row
        while d <= maxdepth:
            if r[m] <= e:
                out.append((totallength - (q + d), d, int(r[m])))
                return
            if r.min() > e or q + d >= n:
                return
            cc = int(rcodes[q + d])
            if cc == 255:
                return
            r = step_row(r, tag == cc)
            d += 1

    def dfs(lo, hi, depth, row):
        if lo >= hi or depth > maxdepth:
            return
        if row[m] <= e:
            dist = int(row[m])
            for q in locate_all(lo, hi):
                out.append((totallength - (q + depth), depth, dist))
            return
        if row.min() > e:
            return
        covered_hi = lo
        for sym in range(fm_rev.sigma):
            l2 = int(fm_rev.counts_less[sym]) + fm_rev.occ(sym, lo)
            h2 = int(fm_rev.counts_less[sym]) + fm_rev.occ(sym, hi)
            if l2 < h2:
                dfs(l2, h2, depth + 1, step_row(row, tag == sym))
                covered_hi += h2 - l2
        # suffixes whose next char is special (or end): locate + walk
        # (only with -withwildcards; the reference's default nowildcards
        # excludes specials from matches, gt_tagerator.c:170-196)
        nregular = covered_hi - lo
        if nowildcards:
            return
        if nregular < hi - lo:
            for q in locate_all(lo, hi):
                if q + depth >= n:
                    continue
                cc = int(rcodes[q + depth])
                if cc < 4:
                    continue
                context_walk(q, depth + 1, step_row(row, tag == cc))

    dfs(0, fm_rev.bwt.size, 0, init)
    return out


def pck_tagerator_batch(fm_rev: FMIndex, tags: list, max_edits: int,
                        totallength: int, device="cuda") -> list:
    """``pck_tagerator_search`` (nowildcards) for many tags at once
    (``match/querysearch.py::tagerator_batch``): each level's children
    by one batched backward step of ``FMDeviceRank`` on `device`; a
    reported rank r at depth d maps to the forward start totallength -
    (sa[r] + d)."""
    rank = FMDeviceRank(fm_rev, device)
    four = torch.arange(fm_rev.sigma, device=rank.device)

    def children(lo, hi, depth):
        n = lo.size
        c = four.repeat(n)
        cl = rank.counts_less[c].long()
        out = []
        for x in (lo, hi):
            p = torch.from_numpy(np.repeat(x, fm_rev.sigma)).to(rank.device)
            out.append((cl + rank.occ_batch(c, p).long()).view(n, -1)
                       .cpu().numpy())
        return out[0], out[1]

    return tagerator_batch(
        tags, max_edits, children,
        lambda slots, d: totallength - (fm_rev.sa_full[slots] + d),
        fm_rev.bwt.size)
