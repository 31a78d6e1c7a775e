"""Tallymer: k-mer counting and occurrence search.

The port's copy of ``genometools_tpu/match/tallymer.py`` (host code:
the reference does no device work here; its index comes from the
port's suffixerator, which sorts on the card). Capability equivalent
of the reference tyr-* family (ref: src/match/tyr-mkindex.c,
tyr-search.c, tyr-mersplit.c).

mkindex redesign: the reference walks a suffix-tree DFS over the ESA
(ref: tyr-mkindex.c:514 enumeratelcpintervals). Because the suffix array
lists mers in lexicographic order, the same result is a *vectorized
segmentation*: a rank r contributes a k-mer iff its suffix has >= k
regular characters; ranks with lcp >= k continue the previous mer's run;
run boundaries (lcp[r] < k) delimit distinct mers, and counts are run
lengths. No traversal, no stack: two scans and a cumsum.

Index files follow the reference formats:
  .mer — sorted mers, 2-bit packed MERBYTES(k) = ceil(k/4) bytes each
          (ref: src/match/tyr-basic.h:24-28)
  .mct — one count byte per mer capped at 255; larger counts spill to a
          (merindex, count) list appended after the byte section
          (ref: src/match/tyr-mkindex.c Largecount)
  .mbd — prefix-code bucket directory for O(1) bucket lookup
          (ref: src/match/tyr-mersplit.c)
Here .mct/.mbd carry a tiny JSON+npz container instead of raw C structs
(byte layouts of the reference are r/w by `merfiles_compat` if needed).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..core.chardef import is_special
from ..core.encseq import Encseq
from ..index.esa import EnhancedSuffixArray
from ..ops.kmer import kmer_codes_np, pack_mers_2bit


class MerIndex:
    """mersize, mer_codes (int64[nmers], sorted ascending), counts.

    The native mkindex path stores the packed 2-bit form and defers the
    int64 code materialization (save() never needs it); `mer_codes` is
    a lazy property in that case."""

    def __init__(self, mersize: int, mer_codes, counts,
                 alphabet_size: int = 4):
        self.mersize = mersize
        self._mc = mer_codes
        self._ct = counts
        self.alphabet_size = alphabet_size

    @property
    def mer_codes(self) -> np.ndarray:
        if self._mc is None and getattr(self, "_packed", None) is not None:
            # unsigned: at k = 31 the eight packed bytes fill the top
            # bit, which the reference's int64 shift sign-extends
            packed = self._packed
            code = np.zeros(packed.shape[0], np.uint64)
            for b in range(packed.shape[1]):
                code = (code << np.uint64(8)) | \
                    packed[:, b].astype(np.uint64)
            self._mc = (code >> np.uint64(
                (packed.shape[1] * 4 - self.mersize) * 2)).astype(np.int64)
        return self._mc

    @mer_codes.setter
    def mer_codes(self, v) -> None:
        self._mc = v

    @property
    def num_mers(self) -> int:
        if self._ct is not None:
            return int(self._ct.size)
        return int(self._counts_small.size)

    # -- persistence -------------------------------------------------------
    def save(self, indexname: str) -> None:
        packed = getattr(self, "_packed", None)
        if packed is None:
            packed = pack_mers_2bit(self.mer_codes, self.mersize)
        with open(indexname + ".mer", "wb") as f:
            np.ascontiguousarray(packed).tofile(f)
            # reference footer: mersize + alphasize as uint64
            # (ref: src/match/tyr-mkindex.c outputsortedstring tail)
            f.write(np.asarray([self.mersize, self.alphabet_size],
                               np.uint64).tobytes())
        small = np.minimum(self.counts, 255).astype(np.uint8)
        large_idx = np.nonzero(small == 255)[0]
        large_idx = large_idx[self.counts[large_idx] > 255]
        with open(indexname + ".mct", "wb") as f:
            small.tofile(f)
            lg = np.empty((large_idx.size, 2), np.uint64)
            lg[:, 0] = large_idx
            lg[:, 1] = self.counts[large_idx]
            f.write(lg.tobytes())
        meta = {"mersize": self.mersize, "nummers": self.num_mers,
                "numlarge": int(large_idx.size),
                "alphabetsize": self.alphabet_size}
        Path(indexname + ".tyr.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, indexname: str) -> "MerIndex":
        """Memory-maps .mer/.mct: nothing is decoded until touched
        (the reference mmaps too, ref: tyr-search.c mapping the index);
        counts stay as capped bytes + a large-value overflow table."""
        meta = json.loads(Path(indexname + ".tyr.json").read_text())
        k = meta["mersize"]
        nm = meta["nummers"]
        merbytes = (k + 3) // 4
        packed = np.memmap(indexname + ".mer", dtype=np.uint8,
                           mode="r", shape=(nm, merbytes))
        mct = np.memmap(indexname + ".mct", dtype=np.uint8, mode="r")
        small = mct[:nm]
        rest = np.asarray(mct[nm:]).tobytes()
        mi = cls(k, None, None, meta.get("alphabetsize", 4))
        mi._packed = packed
        mi._counts_small = small
        mi._large = np.frombuffer(rest, np.uint64).reshape(-1, 2) \
            if rest else np.zeros((0, 2), np.uint64)
        return mi

    @property
    def counts(self) -> np.ndarray:
        if self._ct is None:
            ct = self._counts_small.astype(np.uint32)
            if self._large.size:
                ct[self._large[:, 0].astype(np.int64)] = \
                    self._large[:, 1].astype(np.uint32)
            self._ct = ct
        return self._ct

    @counts.setter
    def counts(self, v) -> None:
        self._ct = v

    def counts_at(self, idx: np.ndarray) -> np.ndarray:
        """Counts for specific mer indices without materializing the
        whole table (hits are sparse in a typical search)."""
        if self._ct is not None:
            return self._ct[idx].astype(np.int64)
        ct = self._counts_small[idx].astype(np.int64)
        if self._large.size:
            ov = {int(i): int(v) for i, v in self._large}
            for j in np.flatnonzero(ct == 255):
                ct[j] = ov.get(int(idx[j]), 255)
        return ct

    def lookup(self, qcodes: np.ndarray):
        """(idx, hit): rank of each query code among the sorted mers.
        Small query batches binary-search the packed rows directly
        (touches O(nq log nm) rows — no full-index decode); large
        batches build the uint64 key table once and searchsorted."""
        merbytes = (self.mersize + 3) // 4
        packed = getattr(self, "_packed", None)
        nm = self.num_mers
        kshift = (merbytes * 4 - self.mersize) * 2
        if packed is not None and self._ct is None and \
                qcodes.size * 64 < nm and nm:
            w = (256 ** np.arange(merbytes - 1, -1, -1)).astype(np.int64)
            qv = qcodes.astype(np.int64) << kshift
            lo = np.zeros(qcodes.size, np.int64)
            hi = np.full(qcodes.size, nm, np.int64)
            for _ in range(int(np.ceil(np.log2(max(nm, 2)))) + 1):
                mid = (lo + hi) >> 1
                mv = packed[np.minimum(mid, nm - 1)].astype(np.int64) @ w
                less = (mv < qv) & (mid < hi)
                lo = np.where(less, mid + 1, lo)
                hi = np.where(less, hi, mid)
            idx = lo
            idx_c = np.minimum(idx, nm - 1)
            hit = (idx < nm) & \
                ((packed[idx_c].astype(np.int64) @ w) == qv)
            return idx_c, hit
        qk = qcodes.astype(np.uint64) << kshift
        if packed is not None and nm and qcodes.size >= (1 << 14):
            from ..core.native import tyr_lookup_native
            res = tyr_lookup_native(np.asarray(packed), qk)
            if res is not None:
                return res
        keys = self.sort_keys()
        idx = np.searchsorted(keys, qk)
        idx_c = np.clip(idx, 0, max(nm - 1, 0))
        hit = (idx < nm) & (keys[idx_c] == qk)
        return idx_c, hit

    def sort_keys(self):
        """uint64 keys = mer code << 2*(4*merbytes - k): the packed
        big-endian bytes zero-padded to 8 — order-isomorphic to the
        codes, built with one pass instead of the per-byte int64 loop
        (queries apply the same shift before searchsorted)."""
        keys = getattr(self, "_keys", None)
        if keys is None:
            merbytes = (self.mersize + 3) // 4
            packed = getattr(self, "_packed", None)
            if packed is None:
                keys = self.mer_codes.astype(np.uint64) << \
                    ((merbytes * 4 - self.mersize) * 2)
            else:
                pad = np.zeros((packed.shape[0], 8), np.uint8)
                pad[:, 8 - merbytes:] = packed
                keys = pad.reshape(-1).view(np.dtype(">u8")) \
                    .astype(np.uint64)
            self._keys = keys
        return keys

    # -- bucket directory (mersplit) ---------------------------------------
    def bucket_directory(self, prefixlength: int | None = None
                         ) -> tuple[int, np.ndarray]:
        """(prefixlength, boundaries[4^pl + 1]) — mers with prefix code c
        occupy [bounds[c], bounds[c+1]) (ref: tyr-mersplit.c)."""
        if prefixlength is None:
            prefixlength = min(self.mersize, max(
                1, int(np.log2(max(self.num_mers, 2)) // 2)))
        shift = 2 * (self.mersize - prefixlength)
        pref = (self.mer_codes >> shift).astype(np.int64)
        nb = 4 ** prefixlength
        bounds = np.searchsorted(pref, np.arange(nb + 1))
        return prefixlength, bounds


def mkindex_direct(enc, mersize: int, minocc: int = 1,
                   maxocc: int | None = None) -> "MerIndex | None":
    """ESA-free mkindex: count k-mers straight off the encseq via the
    native radix counter (byte-identical .mer/.mct output to the ESA
    walk, ref: src/match/tyr-mkindex.c) — skips the .suf/.lcp load
    entirely.  Forward readmode only; None when unavailable."""
    from ..core.native import tallymer_count_native
    n = enc.num_sequences
    starts = np.asarray([enc.seq_startpos(s) for s in range(n)], np.int64)
    lens = np.asarray(enc.seq_length(np.arange(n)), np.int64) \
        if n else np.zeros(0, np.int64)
    res = tallymer_count_native(enc.codes, starts, lens, mersize,
                                minocc, maxocc)
    if res is None:
        return None
    packed, cnts, small_ct = res
    mi = MerIndex(mersize, None, cnts)
    mi._packed = packed
    return mi


def mkindex(esa: EnhancedSuffixArray, mersize: int,
            minocc: int = 1, maxocc: int | None = None) -> MerIndex:
    """Count all k-mers of the indexed sequence set (both the engine and
    semantics of `gt tallymer mkindex` over one ESA)."""
    enc = esa.encseq
    codes = enc.codes_view(esa.readmode)
    n = codes.size
    k = mersize
    if n < k:
        return MerIndex(k, np.zeros(0, np.int64), np.zeros(0, np.int64))
    # host fast path: single linear ESA pass in C++ (same run
    # segmentation; ~10x the numpy formulation at 32Mbp)
    from ..core.native import tallymer_mkindex_native
    small = getattr(esa, "lcp_small", None)
    if small is None and esa.lcptab is not None:
        small = np.minimum(esa.lcptab, 255).astype(np.uint8)
    res = tallymer_mkindex_native(
        codes, esa.suftab, small, k, minocc, maxocc) \
        if small is not None else None
    if res is not None:
        packed, cnts, small_ct = res
        mi = MerIndex(k, None, cnts)   # uint32 counts: consumers only read
        mi._packed = packed
        return mi
    sa = esa.suftab.astype(np.int64)
    # the capped byte table is exact for `lcp < k` whenever k <= 255
    lcp = esa.lcptab if esa.lcptab is not None else small
    code, valid = kmer_codes_np(codes, k)
    # ranks whose suffix contributes a mer: position has a full valid window
    ok = (sa <= n - k)
    ok &= np.where(ok, valid[np.clip(sa, 0, max(n - k, 0))], False)
    # run boundaries: lcp < k starts a new mer
    newrun = lcp < k
    # count per run among ok ranks, emit mer code from any member
    run_id = np.cumsum(newrun) - 1
    run_ok = run_id[ok]
    nruns = int(run_id[-1]) + 1 if run_id.size else 0
    counts = np.bincount(run_ok, minlength=nruns)
    # representative position per run (first ok member)
    first_idx = np.full(nruns, -1, np.int64)
    idx_ok = np.nonzero(ok)[0]
    # reverse to get first occurrence via assignment
    first_idx[run_ok[::-1]] = idx_ok[::-1]
    present = counts > 0
    mer_codes = np.zeros(nruns, np.int64)
    mer_codes[present] = code[sa[first_idx[present]]]
    sel = present & (counts >= minocc)
    if maxocc is not None:
        sel &= counts <= maxocc
    return MerIndex(k, mer_codes[sel], counts[sel].astype(np.int64))


def occurrence_distribution(merindex: MerIndex) -> dict[int, int]:
    """count -> how many distinct mers (`gt tallymer mkindex` histogram
    mode, ref: tyr-mkindex.c adddistpos2distribution)."""
    vals, cnts = np.unique(merindex.counts, return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, cnts)}


@dataclass
class MerSearchResult:
    qseqnum: np.ndarray
    qpos: np.ndarray
    counts: np.ndarray
    strand: np.ndarray  # ord('+') or ord('-')
    codes: np.ndarray


def search(merindex: MerIndex, queries: Encseq,
           forward: bool = True, reverse: bool = True) -> MerSearchResult:
    """Stream query windows against the mer index
    (ref: gt_tyrsearch, src/match/tyr-search.c:213). Vectorized: all query
    windows are encoded at once and matched with one searchsorted per
    strand (log #mers per window; the .mbd bucket directory is subsumed by
    searchsorted's binary search)."""
    k = merindex.mersize
    codes = queries.codes_view(0)
    n = codes.size
    if n < k:
        z = np.zeros(0, np.int64)
        return MerSearchResult(z, z, z, z, z)
    code, valid = kmer_codes_np(codes, k)
    pos = np.arange(n - k + 1)
    seqnum = queries.seqnum_of_pos(pos)
    relpos = pos - queries.seq_startpos(seqnum)
    out_qs, out_qp, out_ct, out_st, out_cd = [], [], [], [], []

    def one_strand(qcodes, strand_char):
        idx_c, hit = merindex.lookup(qcodes)
        hit = hit & valid
        out_qs.append(seqnum[hit])
        out_qp.append(relpos[hit])
        out_ct.append(merindex.counts_at(idx_c[hit]))
        out_st.append(np.full(int(hit.sum()), ord(strand_char), np.int64))
        out_cd.append(qcodes[hit])

    if forward:
        one_strand(code, "+")
    if reverse:
        # reverse complement of each window: code arithmetic
        rc = _revcomp_codes(code, k)
        one_strand(rc, "-")
    qs, qp, ct, st, cd = (np.concatenate(x) if x
                          else np.zeros(0, np.int64)
                          for x in (out_qs, out_qp, out_ct, out_st,
                                    out_cd))
    # reference emission order: query windows in order, forward before
    # reverse at the same window (ref: tyr-search.c singleseqtyrsearch)
    order = np.lexsort((st, qp, qs))
    return MerSearchResult(qs[order], qp[order], ct[order], st[order],
                           cd[order])


def _revcomp_codes(code: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement k-mer codes (2-bit, complement = 3-x)."""
    out = np.zeros_like(code)
    c = code.copy()
    for _ in range(k):
        out = (out << 2) | (3 - (c & 3))
        c >>= 2
    return out


def mkindex_bruteforce(encseq: Encseq, mersize: int) -> MerIndex:
    """Oracle: hash every window directly (mirror of the reference's
    -test brute-force recount, ref: tyr-mkindex.c:87-150)."""
    codes = encseq.codes
    code, valid = kmer_codes_np(codes, mersize) if codes.size >= mersize \
        else (np.zeros(0, np.int64), np.zeros(0, bool))
    vals, cnts = np.unique(code[valid], return_counts=True)
    return MerIndex(mersize, vals.astype(np.int64), cnts.astype(np.int64))


def occratio(esa: EnhancedSuffixArray, minmersize: int, maxmersize: int):
    """unique/nonunique mer-count distributions over a mersize range
    (ref: src/match/tyr-occratio.c, `gt tallymer occratio`).
    Returns {mersize: (unique, nonunique, total)}."""
    out = {}
    for k in range(minmersize, maxmersize + 1):
        mi = mkindex(esa, k)
        unique = int((mi.counts == 1).sum())
        nonunique = int((mi.counts > 1).sum())
        out[k] = (unique, nonunique, mi.num_mers)
    return out


def mkindex_stream(reader, encseq: Encseq, mersize: int,
                   minocc: int = 1, maxocc: int | None = None,
                   readmode: int = 0) -> MerIndex:
    """`tallymer mkindex` from a SequentialSuffixArrayReader: one pass
    over (suf, lcp) chunks with a run carry across chunk boundaries, so
    memory is bounded by the chunk size + the emitted mer list (the
    reference's streamed enumeratelcpintervals model,
    ref: src/match/tyr-mkindex.c:514 over esa-seqread). Output identical
    to mkindex()."""
    codes = encseq.codes_view(readmode)
    n = codes.size
    k = mersize
    if n < k:
        return MerIndex(k, np.zeros(0, np.int64), np.zeros(0, np.int64))
    mers: list[np.ndarray] = []
    counts: list[np.ndarray] = []
    # open run carry: current run's mer code (or -1) and count so far
    cur_code = -1
    cur_count = 0

    def win_codes(pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(packed k-mer code, window-valid) for suffix start positions."""
        ok = pos <= n - k
        code = np.zeros(pos.size, np.int64)
        base = np.clip(pos, 0, max(n - 1, 0))
        for j in range(k):
            c = codes[np.minimum(base + j, n - 1)]
            ok &= ~is_special(c)
            code = (code << 2) | np.where(is_special(c), 0, c)
        return code, ok

    for suf, lcp in reader.chunks():
        newrun = lcp < k
        code, ok = win_codes(suf)
        # runs within this chunk: boundary indices where newrun
        bnd = np.flatnonzero(newrun)
        # contributions per segment [prev_bnd, next_bnd)
        seg = np.cumsum(newrun) - newrun            # 0-based local run id
        # continue the carried run with the pre-first-boundary entries
        first_b = bnd[0] if bnd.size else suf.size
        head_ok = ok[:first_b]
        cur_count += int(head_ok.sum())
        if cur_code < 0 and head_ok.any():
            cur_code = int(code[:first_b][head_ok][0])
        if bnd.size:
            if cur_count > 0 and cur_code >= 0:
                mers.append(np.asarray([cur_code], np.int64))
                counts.append(np.asarray([cur_count], np.int64))
            # middle runs: start at bnd[i], end before bnd[i+1]
            run_id = np.cumsum(newrun) - 1
            okm = ok.copy()
            okm[:first_b] = False
            rid = run_id[okm]
            nruns = int(run_id[-1]) + 1
            ccnt = np.bincount(rid, minlength=nruns)
            first_idx = np.full(nruns, -1, np.int64)
            idx_ok = np.nonzero(okm)[0]
            first_idx[rid[::-1]] = idx_ok[::-1]
            # all complete runs except the last (it may continue into
            # the next chunk)
            last_run = nruns - 1
            present = (ccnt > 0) & (np.arange(nruns) < last_run) \
                & (np.arange(nruns) >= run_id[first_b])
            if present.any():
                mers.append(code[first_idx[present]])
                counts.append(ccnt[present].astype(np.int64))
            # carry the last run
            tail_sel = okm & (run_id == last_run)
            cur_count = int(tail_sel.sum())
            cur_code = int(code[np.nonzero(tail_sel)[0][0]]) \
                if cur_count else -1
    if cur_count > 0 and cur_code >= 0:
        mers.append(np.asarray([cur_code], np.int64))
        counts.append(np.asarray([cur_count], np.int64))
    mc = np.concatenate(mers) if mers else np.zeros(0, np.int64)
    cc = np.concatenate(counts) if counts else np.zeros(0, np.int64)
    sel = cc >= minocc
    if maxocc is not None:
        sel &= cc <= maxocc
    return MerIndex(k, mc[sel], cc[sel])
