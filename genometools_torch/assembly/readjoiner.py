"""Readjoiner: string-graph assembler (prefilter / overlap / assembly).

The port's copy of ``genometools_tpu/assembly/readjoiner.py``: host code
over the native C++ engines, as in the reference. The one device step
is find_contained's suffix sort when the native SA-IS is missing; it
runs on the caller's device through the port's build_suffix_array.
Capability equivalent of `gt readjoiner` (ref: src/tools/gt_readjoiner*.c,
engines src/match/rdj-*.c, firstcodes*.c).

Phases and their redesign:
  prefilter (ref: gt_readjoiner_prefilter.c:277, rdj-contfinder.c) —
    drop reads containing wildcards, then mark duplicate/contained reads
    (a read is contained iff it occurs as a substring of another read or
    its reverse complement). Implemented via vectorized window join
    instead of the reference's 2-bit radix trie.
  overlap (ref: gt_readjoiner_overlap.c:226, firstcodes.c, esa-spmsk.c) —
    all suffix-prefix matches (SPMs) >= minlen over the mirrored read set.
    Redesign: join minlen-anchor codes of every suffix window against
    read-prefix codes (two bincount/searchsorted passes — the same
    sort+merge-join shape as the reference's firstcodes, but batch
    vectorized), then verify tails. Canonical strand rule: an SPM and its
    reverse-complement dual are the same biological overlap; keep the
    orientation with suffix_m + prefix_m <= 2n-1 in mirrored numbering
    (matches the reference's .spm outputs, validated against
    testdata/readjoiner/{tiny_mirrored.spm, pw-ex.spm}).
  assembly (ref: gt_readjoiner_assembly.c:478, rdj-strgraph.c) —
    bidirected string graph from maximal SPMs; transitive reduction,
    dead-end and bubble removal; unitig spelling with
    `contig_N length=L depth=D` FASTA headers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.alphabet import dna_alphabet
from ..core.chardef import UNDEFCHAR, WILDCARD
from ..core.seqio import SeqSet, read_seqfiles


class ReadSet:
    """2-bit-clean read set: uint8 code arrays, no wildcards.

    Canonical storage is FLAT (one blob + offsets) so bulk consumers
    never touch 100k small arrays; `reads` is a lazily built list of
    views kept for per-read consumers."""

    def __init__(self, reads: list | None = None,
                 copynum: np.ndarray | None = None, *,
                 blob: np.ndarray | None = None,
                 lens: np.ndarray | None = None):
        self.copynum = copynum
        self._reads = reads
        self._rcblob = None
        if blob is not None:
            self.blob = np.ascontiguousarray(blob, np.uint8)
            self.lens = np.ascontiguousarray(lens, np.int64)
            self.starts = np.cumsum(self.lens) - self.lens
        elif reads is not None:
            self.lens = np.fromiter((len(r) for r in reads), np.int64,
                                    len(reads))
            self.blob = np.concatenate(reads) if reads \
                else np.zeros(0, np.uint8)
            self.starts = np.cumsum(self.lens) - self.lens
        else:
            self.blob = np.zeros(0, np.uint8)
            self.lens = np.zeros(0, np.int64)
            self.starts = np.zeros(0, np.int64)

    @property
    def reads(self) -> list:
        if self._reads is None:
            s, e = self.starts.tolist(), (self.starts + self.lens).tolist()
            self._reads = [self.blob[a:b] for a, b in zip(s, e)]
        return self._reads

    @property
    def rcblob(self) -> np.ndarray:
        """Same layout as blob with every read reverse-complemented in
        place (one vectorized gather)."""
        if self._rcblob is None:
            if self.blob.size == 0:
                self._rcblob = self.blob
            elif self.lens.size and int(self.lens.min()) == \
                    int(self.lens.max()):
                # uniform read length: the global reversal holds every
                # read's rc contiguously in reversed read order
                L = int(self.lens[0])
                rev = (3 - self.blob)[::-1]
                self._rcblob = np.ascontiguousarray(
                    rev.reshape(-1, L)[::-1]).reshape(-1)
            else:
                rid = np.repeat(np.arange(self.lens.size), self.lens)
                src = self.starts[rid] + (self.starts[rid] +
                                          self.lens[rid] - 1) - \
                    np.arange(self.blob.size)
                self._rcblob = (3 - self.blob[src]).astype(np.uint8)
        return self._rcblob

    @property
    def num_reads(self) -> int:
        return int(self.lens.size)

    @classmethod
    def from_files(cls, paths: list[str], maxlow: int | None = None,
                   lowqual: int = 0, phredbase: int = 33) -> "ReadSet":
        if maxlow is None:
            # native single-pass FASTA -> clean blob (quality filters
            # need the FASTQ parser)
            from ..core.native import fasta_clean_reads_native
            blobs, lens = [], []
            ok = True
            for p in paths:
                try:
                    data = open(p, "rb").read()
                except OSError:
                    ok = False
                    break
                if not data.lstrip()[:1] == b">":
                    ok = False
                    break
                res = fasta_clean_reads_native(data)
                if res is None:
                    ok = False
                    break
                blobs.append(res[0])
                lens.append(res[1])
            if ok and blobs:
                return cls(blob=np.concatenate(blobs),
                           lens=np.concatenate(lens))
        return cls.from_seqset(read_seqfiles(paths), maxlow=maxlow,
                               lowqual=lowqual, phredbase=phredbase)

    @classmethod
    def from_seqset(cls, seqset: SeqSet, maxlow: int | None = None,
                    lowqual: int = 0, phredbase: int = 33) -> "ReadSet":
        """prefilter step 1: encode, reject reads with non-ACGT chars
        (ref: reads2twobit.c skips reads with ambiguities) and, for
        FASTQ with -maxlow, reads with more than ``maxlow`` positions of
        phred quality <= ``lowqual`` (ref: reads2twobit.c:573
        gt_reads2twobit_apply_quality_filter)."""
        alpha = dna_alphabet()
        quals = seqset.quals if maxlow is not None else None
        if quals is None and seqset.seqs:
            # bulk path: one LUT gather over the concatenated bytes,
            # per-read clean/empty test via reduceat, one split
            lens = np.fromiter((len(s) for s in seqset.seqs), np.int64,
                               len(seqset.seqs))
            codes = alpha.encode(np.concatenate(seqset.seqs))
            ends = np.cumsum(lens)
            starts = ends - lens
            wc = np.concatenate([[0], np.cumsum(codes >= 4)])
            nbad = wc[ends] - wc[starts]       # wildcards per read
            keepmask = (lens > 0) & (nbad == 0)
            posmask = np.repeat(keepmask, lens)
            return cls(blob=codes[posmask], lens=lens[keepmask])
        reads = []
        for i, seq in enumerate(seqset.seqs):
            if quals is not None and i < len(quals) \
                    and quals[i] is not None:
                q = np.asarray(quals[i], np.int64) - phredbase
                if int((q <= lowqual).sum()) > maxlow:
                    continue
            codes = alpha.encode(seq)
            if codes.size and (codes < 4).all():
                reads.append(codes)
        return cls(reads)

    def rc(self, r: int) -> np.ndarray:
        s = int(self.starts[r])
        return self.rcblob[s:s + int(self.lens[r])]


def _read_code(codes: np.ndarray, start: int, k: int) -> int:
    c = 0
    for x in codes[start:start + k]:
        c = c * 4 + int(x)
    return c


def _window_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """int64 codes of all k-windows of a read (k <= 31)."""
    n = codes.size - k + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    out = np.zeros(n, np.int64)
    for j in range(k):
        out = out * 4 + codes[j:j + n].astype(np.int64)
    return out


def find_contained(readset: ReadSet, singlestrand: bool = False,
                   device="cuda") -> np.ndarray:
    """Boolean mask of contained reads (ref: rdj-contfinder.c:867).

    Read r is contained iff it occurs as a substring of some other read
    (or a read's reverse complement unless singlestrand). Duplicate
    groups (identical content, or identical to another read's reverse
    complement) keep their smallest read number.

    Sort-based design replacing the reference's radix trie: build one
    suffix array over the concatenation of all reads (+ their reverse
    complements) with per-position separators, via the linear-time
    SA-IS constructor (native; without it, build_suffix_array on
    `device`) plus Kasai LCP.  In suffix order, every occurrence of read
    r's full content is inside the maximal run of suffixes whose lcp with the
    read-start suffix is >= len(r); within that run

      * an entry from another source read with a longer read length is
        a proper-containment witness (lcp >= len(r) already implies the
        occurrence has len(r) non-special symbols remaining), and
      * an offset-0 entry of an equal-length read is a duplicate /
        rc-duplicate witness (mark r iff a witness has a smaller read
        number).

    Cost: O(total_bases) construction + per-read run scans (a run is
    exactly the occurrence set of that read's content).
    """
    n = readset.num_reads
    contained = np.zeros(n, bool)
    if n == 0:
        return contained

    rlen0 = readset.lens
    if n > 1 and (rlen0 == rlen0[0]).all():
        # equal-length reads: proper containment is impossible, only the
        # duplicate rule applies — group identical rows (reads + their
        # reverse complements) with one void-view sort instead of a
        # 2x-total-bases suffix array
        L = int(rlen0[0])
        fwd = np.vstack(readset.reads)
        rows = fwd if singlestrand else \
            np.vstack([fwd, 3 - fwd[:, ::-1]])
        src = np.concatenate([np.arange(n)] * (1 if singlestrand else 2))
        flat = np.ascontiguousarray(rows).view(
            np.dtype((np.void, L))).reshape(-1)
        _, inv = np.unique(flat, return_inverse=True)
        gmin = np.full(int(inv.max()) + 1, n, np.int64)
        np.minimum.at(gmin, inv, src)
        return gmin[inv[:n]] < np.arange(n)

    # --- concat: fwd reads (+ rc reads) with separator keys -----------
    parts = list(readset.reads)
    src = [np.full(len(p), i, np.int32) for i, p in enumerate(parts)]
    if not singlestrand:
        parts += [readset.rc(r) for r in range(n)]
        src += [np.full(len(readset.reads[i]), i, np.int32)
                for i in range(n)]
    lens = np.fromiter((len(p) for p in parts), np.int64, len(parts))
    starts = np.cumsum(lens + 1) - (lens + 1)
    total = int(lens.sum()) + len(parts)      # one separator after each
    codes = np.full(total, 255, np.uint8)
    mask = np.ones(total, bool)
    mask[np.cumsum(lens + 1) - 1] = False
    codes[mask] = np.concatenate(parts)
    srcread = np.full(total, -1, np.int32)
    srcread[mask] = np.concatenate(src)
    offset0 = np.zeros(total, bool)
    offset0[starts] = True

    keys = np.where(codes < 4, codes.astype(np.int32),
                    4 + np.arange(total, dtype=np.int32))
    from ..core.native import kasai_lcp_native, sais_native
    sa = sais_native(keys)
    if sa is None:
        from ..index.suffix import build_suffix_array
        sa, _ = build_suffix_array(keys, with_lcp=False, device=device)
        sa = sa.cpu().numpy()
    lcp = kasai_lcp_native(keys, sa)
    if lcp is None:
        from ..index.suffix import kasai_lcp
        lcp = kasai_lcp(keys, sa)
    inv = np.empty(total, np.int64)
    inv[sa] = np.arange(total)

    sa_src = srcread[sa]                      # source read per suffix
    rlen = readset.lens
    sa_len = np.where(sa_src >= 0, rlen[np.maximum(sa_src, 0)], 0)
    sa_off0 = offset0[sa]

    read_starts = starts[:n]
    if n > 1 and (rlen == rlen[0]).all():
        # equal-length fast path (the typical large read set): with one
        # global L, the runs are the segments between lcp < L breaks —
        # one vectorized group-by instead of per-read walks.  Proper
        # containment is impossible (no longer read), so only the
        # duplicate rule applies: mark r iff its segment has an
        # offset-0 entry with a smaller read number.
        L = int(rlen[0])
        seg = np.cumsum(lcp < L)              # segment id per SA slot
        INF = np.int32(n)
        cand = np.where(sa_off0 & (sa_src >= 0), sa_src, INF)
        nseg = int(seg[-1]) + 1
        seg_min = np.full(nseg, INF, np.int32)
        np.minimum.at(seg_min, seg, cand)
        t = inv[read_starts]                  # SA slot of each read start
        return seg_min[seg[t]] < np.arange(n)

    for r in range(n):
        L = int(rlen[r])
        t = int(inv[read_starts[r]])
        # maximal run [a, b] with pairwise lcp >= L around t
        a = t
        while a > 0 and lcp[a] >= L:
            a -= 1
        b = t
        while b + 1 < total and lcp[b + 1] >= L:
            b += 1
        if a == b:
            continue
        seg_src = sa_src[a:b + 1]
        other = seg_src != r
        if (other & (sa_len[a:b + 1] > L)).any():
            contained[r] = True
        elif (other & sa_off0[a:b + 1] & (sa_len[a:b + 1] == L)
              & (seg_src < r)).any():
            contained[r] = True
    return contained


@dataclass
class SpmList:
    suf_read: np.ndarray
    suf_strand: np.ndarray   # True == '+'
    pref_read: np.ndarray
    pref_strand: np.ndarray
    length: np.ndarray

    def lines(self) -> list[str]:
        out = []
        for sr, ss, pr, ps, l in zip(self.suf_read, self.suf_strand,
                                     self.pref_read, self.pref_strand,
                                     self.length):
            out.append(f"{sr} {'+' if ss else '-'} {pr} "
                       f"{'+' if ps else '-'} {l}")
        return out

    def write_bin(self, path: str, bits: int = 32) -> None:
        """Reference binary .spm format (ref: rdj-spmlist.c:37-125):
        one header byte (GT_SPMLIST_BIN32=2 / BIN64=3), then per match
        three little-endian words (suffix_seqnum, prefix_seqnum,
        length << 2 | suffix_direct << 1 | prefix_direct)."""
        dt = np.uint32 if bits == 32 else np.uint64
        packed = (self.length.astype(np.uint64) << 2) \
            | (self.suf_strand.astype(np.uint64) << 1) \
            | self.pref_strand.astype(np.uint64)
        tri = np.stack([self.suf_read.astype(np.uint64),
                        self.pref_read.astype(np.uint64),
                        packed], axis=1).astype(dt)
        with open(path, "wb") as f:
            f.write(bytes([2 if bits == 32 else 3]))
            tri.tofile(f)

    @classmethod
    def read(cls, path: str, min_length: int = 0) -> "SpmList":
        """Auto-detecting reader: binary 32/64 (header byte 2/3,
        ref: rdj-spmlist.c:270-285) or plain text."""
        with open(path, "rb") as f:
            first = f.read(1)
            if first and first[0] in (2, 3):
                dt = np.uint32 if first[0] == 2 else np.uint64
                tri = np.fromfile(f, dtype=dt).reshape(-1, 3)
                length = (tri[:, 2] >> 2).astype(np.int64)
                keep = length >= min_length
                return cls(tri[keep, 0].astype(np.int64),
                           (tri[keep, 2] & 2) != 0,
                           tri[keep, 1].astype(np.int64),
                           (tri[keep, 2] & 1) != 0,
                           length[keep])
        sr, ss, pr, ps, ln = [], [], [], [], []
        for line in open(path):
            parts = line.split()
            if len(parts) != 5:
                continue
            if int(parts[4]) < min_length:
                continue
            sr.append(int(parts[0]))
            ss.append(parts[1] == "+")
            pr.append(int(parts[2]))
            ps.append(parts[3] == "+")
            ln.append(int(parts[4]))
        return cls(np.asarray(sr, np.int64), np.asarray(ss, bool),
                   np.asarray(pr, np.int64), np.asarray(ps, bool),
                   np.asarray(ln, np.int64))


def _equal_runs_ok(blob: np.ndarray, a: np.ndarray, b: np.ndarray,
                   need: np.ndarray) -> np.ndarray:
    """bool per pair: blob[a:a+need] == blob[b:b+need], chunk-compared
    32 symbols at a time with early exit per pair."""
    m = a.size
    good = np.ones(m, bool)
    if m == 0:
        return good
    l = np.zeros(m, np.int64)
    act = np.flatnonzero(need > 0)
    STEP = 32
    steps = np.arange(STEP, dtype=np.int64)
    nmax = blob.size - 1
    while act.size:
        take = np.minimum(need[act] - l[act], STEP)
        ai = np.minimum(a[act, None] + l[act, None] + steps, nmax)
        bi = np.minimum(b[act, None] + l[act, None] + steps, nmax)
        inwin = steps[None, :] < take[:, None]
        mism = (inwin & (blob[ai] != blob[bi])).any(axis=1)
        good[act[mism]] = False
        l[act] += take
        act = act[~mism]
        act = act[l[act] < need[act]]
    return good


def find_spms(readset: ReadSet, minlen: int,
              singlestrand: bool = False,
              irreducible: bool = True,
              lanes: int | None = None) -> SpmList:
    """Suffix-prefix matches >= minlen (ref: firstcodes + esa-spmsk;
    brute-force oracle rdj-ovlfind-bf.c via `gt readjoiner spmtest`).
    irreducible=True (the reference overlap phase's semantics,
    ref: esa-spmsk.c irreducible SPM emission) drops every transitive
    match a->b that an intermediate read c spells identically
    (l_ab == l_ac + l_cb - len(c)); row order of survivors is kept.

    Vectorized join: one rolling k-code pass over the concatenated
    mirrored reads, one sorted-prefix searchsorted per window chunk,
    then a chunked equality verify — no per-read Python loops. lanes:
    the native join's threads (default: one per CPU); the rows do not
    depend on it."""
    n = readset.num_reads
    # mirrored read list: m in [0,n) = read m '+'; m in [n,2n) = rc of
    # read 2n-1-m (the reference's mirrored encseq numbering) — the
    # mirror half IS revcomp(fwd blob), one vectorized pass
    k = minlen if minlen <= 31 else 31
    empty = SpmList(np.zeros(0, np.int64), np.zeros(0, bool),
                    np.zeros(0, np.int64), np.zeros(0, bool),
                    np.zeros(0, np.int64))
    if n == 0:
        return empty
    lens_f = readset.lens
    blob_f = readset.blob
    if singlestrand:
        m_count = n
        lens = lens_f
        blob = blob_f
    else:
        m_count = 2 * n
        lens = np.concatenate([lens_f, lens_f[::-1]])
        blob = np.concatenate([blob_f, (3 - blob_f[::-1])
                               .astype(np.uint8)])
    starts = np.cumsum(lens) - lens
    total = int(blob.size)
    if total < k:
        return empty

    # threaded C++ window-scan join (native/gtnative.cpp gt_spm_find):
    # identical hit set and emission order, no 20M-row index planes
    from ..core.native import spm_find_native
    native = spm_find_native(blob, starts, lens, k, minlen,
                             strand_canon=not singlestrand, lanes=lanes)
    if native is not None:
        A, B, LL = native
        sr = np.where(A < n, A, m_count - 1 - A)
        ss = A < n
        pr = np.where(B < n, B, m_count - 1 - B)
        ps_ = B < n
        if irreducible and LL.size:
            keep = _transitive_keep_rows(
                2 * sr + ss, 2 * pr + ps_, LL.astype(np.int64),
                readset)
            sr, ss, pr, ps_, LL = (sr[keep], ss[keep], pr[keep],
                                   ps_[keep], LL[keep])
        if not LL.size:
            return empty
        return SpmList(sr.astype(np.int64), ss, pr.astype(np.int64),
                       ps_, LL.astype(np.int64))

    rid = np.repeat(np.arange(m_count, dtype=np.int64), lens)

    npos = total - k + 1
    # byte-packed blob: bp[i] = 4 symbols starting at i in one byte, so
    # a k-window is ceil(k/4) byte gathers instead of k symbol gathers
    B = (k + 3) // 4
    pad = (4 * B - k) * 2
    bpad = np.concatenate([blob, np.zeros(3 + 4 * B - 4, np.uint8)])
    bp = ((bpad[:-3] << 6) | (bpad[1:-2] << 4) | (bpad[2:-1] << 2)
          | bpad[3:]).astype(np.uint8)
    bweights = (256 ** np.arange(B - 1, -1, -1, dtype=np.int64))
    boff = 4 * np.arange(B, dtype=np.int64)

    def codes_at(pos):
        # k-symbol codes at selected positions only: ceil(k/4) byte
        # gathers, then shift out the (4B - k) trailing extra symbols
        out = np.empty(pos.size, np.int64)
        CH2 = 1 << 21
        for t in range(0, pos.size, CH2):
            pc = pos[t:t + CH2]
            out[t:t + CH2] = (bp[pc[:, None] + boff].astype(np.int64)
                              @ bweights) >> pad
        return out

    pref_ok = lens >= k
    pref_codes = np.full(m_count, -1, np.int64)
    okr = np.flatnonzero(pref_ok)
    pref_codes[okr] = codes_at(np.minimum(starts[okr], npos - 1))
    order = np.argsort(pref_codes, kind="stable")
    sorted_pref = pref_codes[order]
    # collapse to distinct values: one searchsorted per chunk instead
    # of two (lo from the unique index, count from bincount)
    uniq, ustart, ucnt = np.unique(sorted_pref, return_index=True,
                                   return_counts=True)

    # suffix windows: position p, off = p - start, L = len - off >= minlen
    offs = np.arange(total, dtype=np.int64) - starts[rid]
    Lall = lens[rid] - offs
    sel = np.flatnonzero(Lall[:npos] >= minlen)

    res_a, res_b, res_l = [], [], []
    CH = 1 << 21
    for s0 in range(0, sel.size, CH):
        ps = sel[s0:s0 + CH]
        wc = codes_at(ps)
        ui = np.searchsorted(uniq, wc)
        uic = np.minimum(ui, uniq.size - 1)
        hitu = (ui < uniq.size) & (uniq[uic] == wc)
        lo = ustart[uic]
        cnt = np.where(hitu, ucnt[uic], 0)
        nz = cnt > 0
        ps, lo, cnt = ps[nz], lo[nz], cnt[nz]
        if ps.size == 0:
            continue
        rep = np.repeat(np.arange(ps.size, dtype=np.int64), cnt)
        intra = np.arange(rep.size, dtype=np.int64) - \
            np.repeat(np.cumsum(cnt) - cnt, cnt)
        bidx = order[lo[rep] + intra]
        p_abs = ps[rep]
        aidx = rid[p_abs]
        L = lens[aidx] - (p_abs - starts[aidx])
        keep = (bidx != aidx) & (L < lens[aidx]) & (L < lens[bidx])
        bidx, p_abs, aidx, L = bidx[keep], p_abs[keep], aidx[keep], \
            L[keep]
        ok = _equal_runs_ok(blob, p_abs + k, starts[bidx] + k, L - k)
        res_a.append(aidx[ok])
        res_b.append(bidx[ok])
        res_l.append(L[ok])
    if not res_a:
        return empty
    A = np.concatenate(res_a)
    B = np.concatenate(res_b)
    LL = np.concatenate(res_l)

    # canonicalize strands (mirrored-dual rule) and map to (read, strand)
    if not singlestrand:
        keep = A + B <= m_count - 1
        A, B, LL = A[keep], B[keep], LL[keep]
    sr = np.where(A < n, A, m_count - 1 - A)
    ss = A < n
    pr = np.where(B < n, B, m_count - 1 - B)
    ps_ = B < n
    out = list(zip(sr.tolist(), ss.tolist(), pr.tolist(), ps_.tolist(),
                   LL.tolist()))
    if irreducible and out:
        out = _drop_transitive_spms(out, readset)
    if not out:
        return empty
    return SpmList(
        np.array([o[0] for o in out], np.int64),
        np.array([o[1] for o in out], bool),
        np.array([o[2] for o in out], np.int64),
        np.array([o[3] for o in out], bool),
        np.array([o[4] for o in out], np.int64))


def _drop_transitive_spms(out, readset: ReadSet):
    """Tuple-list wrapper over _transitive_keep_rows."""
    m = len(out)
    if m == 0:
        return out
    arr = np.asarray([(sr, ss, pr, ps, L) for sr, ss, pr, ps, L in out],
                     np.int64)
    keep_rows = _transitive_keep_rows(
        2 * arr[:, 0] + arr[:, 1], 2 * arr[:, 2] + arr[:, 3],
        arr[:, 4], readset)
    return [out[i] for i in keep_rows]


def _transitive_keep_rows(va0, vb0, L0, readset: ReadSet):
    """Row indices of the irreducible SPMs: build the bidirected
    adjacency (incl. dual edges), drop a->b when some a->c->b composes
    to the same layout (the redtrans criterion, ref: rdj-strgraph.c:987
    — applied at SPM level because the reference overlap phase only
    ever emits irreducible matches).

    Vectorized: vertices (read, strand) pack to ints, the max-L edge
    table to sorted packed keys, and the a->c->b triangle test to a
    CSR neighbor expansion + one searchsorted — no per-edge dicts."""
    n2 = 2 * readset.num_reads
    # dual edge: (pr, !ps) -> (sr, !ss); vertex packing flips the
    # strand bit
    va = np.concatenate([va0, vb0 ^ 1])
    vb = np.concatenate([vb0, va0 ^ 1])
    L = np.concatenate([L0, L0])
    key = va * n2 + vb
    # best (max L) per directed pair
    o = np.lexsort((-L, key))
    ks, Ls = key[o], L[o]
    first = np.concatenate([[True], ks[1:] != ks[:-1]])
    ukey, ul = ks[first], Ls[first]
    uva, uvb = ukey // n2, ukey % n2
    # CSR over source vertex (ukey sorted => uva sorted)
    deg = np.bincount(uva, minlength=n2)
    adj_start = np.concatenate([[0], np.cumsum(deg)])
    rl = readset.lens

    # candidate edges: the original rows whose L is the pair maximum
    k0 = va0 * n2 + vb0
    pos = np.searchsorted(ukey, k0)
    is_best = ul[pos] == L0
    # triangle test per best edge: c in adj[va], l_ac > l_ab,
    # edge (c -> vb) with l_ab == l_ac + l_cb - len(c)
    cand = np.flatnonzero(is_best)
    if cand.size:
        d = deg[va0[cand]]
        rep = np.repeat(np.arange(cand.size), d)
        within = np.arange(rep.size) - np.repeat(np.cumsum(d) - d, d)
        ei = adj_start[va0[cand]][rep] + within    # index into u* rows
        vc, l_ac = uvb[ei], ul[ei]
        lab = L0[cand][rep]
        vbb = vb0[cand][rep]
        ok = (vc != vbb) & (vc != va0[cand][rep]) & (l_ac > lab)
        need = lab - l_ac + rl[vc // 2]            # required l_cb
        k2 = vc * n2 + vbb
        p2 = np.searchsorted(ukey, k2)
        p2c = np.minimum(p2, ukey.size - 1)
        hit = ok & (ukey[p2c] == k2) & (ul[p2c] == need)
        red = np.zeros(cand.size, bool)
        np.logical_or.at(red, rep, hit)
        keep_rows = cand[~red]
    else:
        keep_rows = cand
    return keep_rows


# ---------------------------------------------------------------------------
# string graph (ref: rdj-strgraph.c)
# ---------------------------------------------------------------------------

@dataclass
class StringGraph:
    """Bidirected string graph: vertex = (read, end) with end in {B, E}.

    An SPM suffix(a, sa) -> prefix(b, sb) of length L becomes the edge
    "walk out of a's E-side into b" with orientation encoded as in the
    reference (ref: rdj-strgraph.c:398 construction comment).
    Edges: (a, sa, b, sb, L) meaning: reading a on strand sa, continue
    into b on strand sb, overlapping L.
    """

    readset: ReadSet
    edges: list[tuple] = field(default_factory=list)  # (a, sa, b, sb, L)

    @classmethod
    def from_spms(cls, readset: ReadSet, spms: SpmList) -> "StringGraph":
        g = cls(readset)
        # each SPM implies its reverse-complement dual edge; store both
        # so traversal can walk either strand (bidirected graph).
        # Vectorized dedup keeping max overlap per (a,sa,b,sb) key, in
        # first-appearance order (== the insertion-ordered dict)
        n = spms.length.size
        if n == 0:
            return g
        sr = spms.suf_read.astype(np.int64)
        pr = spms.pref_read.astype(np.int64)
        ss = spms.suf_strand.astype(bool)
        ps = spms.pref_strand.astype(bool)
        ln = spms.length.astype(np.int64)
        a = np.concatenate([sr, pr])
        sa = np.concatenate([ss, ~ps])
        b = np.concatenate([pr, sr])
        sb = np.concatenate([ps, ~ss])
        ll = np.concatenate([ln, ln])
        # interleave so the dual follows its SPM, like the dict loop
        order = np.argsort(np.concatenate([np.arange(n) * 2,
                                           np.arange(n) * 2 + 1]),
                           kind="stable")
        a, sa, b, sb, ll = a[order], sa[order], b[order], sb[order], \
            ll[order]
        key = ((a * 2 + sa) << 34) | ((b * 2 + sb) << 1)
        uniq, first, inv = np.unique(key, return_index=True,
                                     return_inverse=True)
        lmax = np.zeros(uniq.size, np.int64)
        np.maximum.at(lmax, inv, ll)
        emit = np.argsort(first, kind="stable")
        ai, bi = a[first][emit], b[first][emit]
        g.edges = list(zip(ai.tolist(), sa[first][emit].tolist(),
                           bi.tolist(), sb[first][emit].tolist(),
                           lmax[emit].tolist()))
        return g

    def reduce_self(self) -> int:
        """Remove self edges (read to itself, either strand)
        (ref: redself/redwithrc, rdj-strgraph.c:892/:937)."""
        before = len(self.edges)
        self.edges = [e for e in self.edges if e[0] != e[2]]
        return before - len(self.edges)

    def _edge_maps(self):
        out_edges = {}
        for a, sa, b, sb, l in self.edges:
            out_edges.setdefault((a, sa), []).append((b, sb, l))
        return out_edges

    def _reduce_transitive_dicts(self) -> int:
        """Reference dict walk (fallback for vertex/overlap ids past the
        packed 21-bit key budget of the vectorized join)."""
        out_edges = self._edge_maps()
        removed = set()
        readlen = self.readset.lens
        for a, sa, c, sc, l_ac in self.edges:
            for b, sb, l_ab in out_edges.get((a, sa), []):
                if (b, sb) == (c, sc) or (b, sb) == (a, sa):
                    continue
                for c2, sc2, l_bc in out_edges.get((b, sb), []):
                    if (c2, sc2) == (c, sc) and \
                            l_ac == l_ab + l_bc - int(readlen[b]):
                        removed.add((a, sa, c, sc, l_ac))
        self.edges = [e for e in self.edges if e not in removed]
        return len(removed)

    def _edge_arrays(self):
        """(a2, b2, l) int64 planes of the edge list, vertex packed as
        read*2 + strand."""
        if not self.edges:
            z = np.zeros(0, np.int64)
            return z, z, z
        e = np.asarray(self.edges, np.int64)
        return e[:, 0] * 2 + e[:, 1], e[:, 2] * 2 + e[:, 3], e[:, 4]

    def reduce_transitive(self) -> int:
        """Remove edge a->c when a->b->c spells the same layout
        (ref: gt_strgraph_redtrans, rdj-strgraph.c:987). Positional
        criterion: c's start via b is len(a)-l_ab + len(b)-l_bc, directly
        it is len(a)-l_ac, so the edge is transitive iff
        l_ac == l_ab + l_bc - len(b).

        Vectorized two-hop join: expand every edge a->b by the out-edges
        of b, build the implied (a, c, l) keys, and mark existing edges
        that match — the same removal set as the per-vertex dict walk."""
        ea, eb, el = self._edge_arrays()
        ne = ea.size
        if ne == 0:
            return 0
        if max(int(ea.max()), int(eb.max())) >= 1 << 21 or \
                int(el.max()) >= 1 << 21:
            return self._reduce_transitive_dicts()
        readlen = self.readset.lens
        order = np.argsort(ea, kind="stable")
        sa_, sb_, sl_ = ea[order], eb[order], el[order]
        # out-run of each vertex in the sorted-by-source view
        run_start = np.searchsorted(sa_, eb)     # per edge: b's out-run
        run_end = np.searchsorted(sa_, eb, side="right")
        cnt = run_end - run_start
        hop = np.repeat(np.arange(ne), cnt)      # first edge a->b
        within = np.arange(cnt.sum()) - np.repeat(
            np.cumsum(cnt) - cnt, cnt)
        succ = run_start[hop] + within           # second edge b->c (sorted idx)
        a2, b2 = ea[hop], eb[hop]
        c2, l_bc = sb_[succ], sl_[succ]
        ok = (b2 != c2) & (b2 != a2)
        l_imp = el[hop] + l_bc - readlen[b2 >> 1]
        # membership: does edge (a2 -> c2, l_imp) exist?
        KEY = (ea << 42) | (eb << 21) | el if ne else None
        cand = (a2 << 42) | (c2 << 21) | l_imp
        skey = np.sort(KEY)
        pos = np.searchsorted(skey, cand[ok])
        pos = np.minimum(pos, max(skey.size - 1, 0))
        hit = skey[pos] == cand[ok]
        hits = np.zeros(0, np.int64) if not hit.any() else \
            np.unique(cand[ok][hit])
        removed_mask = np.isin(KEY, hits)
        before = len(self.edges)
        self.edges = [e for e, r in zip(self.edges, removed_mask)
                      if not r]
        return before - len(self.edges)

    # -- error-correction reductions (ref: rdj-strgraph.c:1131,1230) ---

    def _degrees(self):
        out_edges = {}
        for idx, (a, sa, b, sb, l) in enumerate(self.edges):
            out_edges.setdefault((a, sa), []).append(idx)
        return out_edges

    @staticmethod
    def _other(v):
        return (v[0], not v[1])

    def reduce_dead_paths(self, maxdepth: int = 10) -> int:
        """One round of dead-end path removal (ref:
        gt_strgraph_reddepaths, rdj-strgraph.c:1131): from every
        non-internal vertex, walk chains of internal vertices; a chain
        of <= maxdepth edges that ends at a vertex with no continuation
        (or that started from a non-branching vertex) is marked and
        removed. Returns the number of removed edges."""
        out_edges = self._degrees()

        def outdeg(v):
            return len(out_edges.get(v, []))

        def indeg(v):
            return outdeg(self._other(v))

        def internal(v):
            return outdeg(v) == 1 and indeg(v) == 1

        marked: set[int] = set()
        for v in list(out_edges):
            if internal(v):
                continue
            i_branching = (outdeg(v) > 1 and indeg(v) > 0) or \
                (outdeg(v) == 1 and indeg(v) > 1)
            for ei in out_edges[v]:
                if ei in marked:
                    continue
                path = [ei]
                to = (self.edges[ei][2], self.edges[ei][3])
                depth = 1
                while internal(to) and depth <= maxdepth:
                    depth += 1
                    ej = out_edges[to][0]
                    path.append(ej)
                    to = (self.edges[ej][2], self.edges[ej][3])
                if depth <= maxdepth and (not i_branching
                                          or outdeg(to) == 0):
                    marked.update(path)
        self.edges = [e for i, e in enumerate(self.edges)
                      if i not in marked]
        return len(marked)

    def reduce_bubbles(self, maxwidth: int = 0, maxdiff: int = 1) -> int:
        """One round of p-bubble removal (ref: gt_strgraph_redpbubbles,
        rdj-strgraph.c:1230): from every non-internal vertex, collect
        internal-chain paths as (dest, depth, width = sum of edge
        lengths); sort by (dest, width); adjacent paths to the same
        dest within maxdiff width are bubbles — the shallower path is
        marked and removed. maxwidth=0 uses the reference default
        4*longest_read - 2*minmatchlen - 1."""
        readlen = self.readset.lens
        if maxwidth == 0:
            minmatch = min((e[4] for e in self.edges), default=0)
            maxwidth = (max(readlen, default=0) << 2) - \
                (minmatch << 1) - 1
        out_edges = self._degrees()

        def outdeg(v):
            return len(out_edges.get(v, []))

        def internal(v):
            return outdeg(v) == 1 and outdeg(self._other(v)) == 1

        def edge_len(ei):
            a, sa, b, sb, l = self.edges[ei]
            return readlen[b] - l

        marked: set[int] = set()
        for v in list(out_edges):
            if internal(v):
                continue
            info = []
            for ei in out_edges[v]:
                to = (self.edges[ei][2], self.edges[ei][3])
                depth = 1
                width = edge_len(ei)
                chain = [ei]
                while internal(to) and width <= maxwidth:
                    depth += 1
                    ej = out_edges[to][0]
                    width += edge_len(ej)
                    chain.append(ej)
                    to = (self.edges[ej][2], self.edges[ej][3])
                if width <= maxwidth and depth > 1:
                    info.append((to, width, depth, ei, chain))
            info.sort(key=lambda t: (t[0], t[1]))
            prev = 0
            for p in range(1, len(info)):
                if info[p][0] == info[prev][0] and \
                        info[p][1] - info[prev][1] <= maxdiff:
                    if info[p][2] <= info[prev][2]:
                        victim = p
                    else:
                        victim = prev
                        prev = p
                    marked.update(info[victim][4])
                else:
                    prev = p
        self.edges = [e for i, e in enumerate(self.edges)
                      if i not in marked]
        return len(marked)

    def error_correction(self, bubble_rounds: int = 3,
                         deadend_rounds: int = 10,
                         deadend_depth: int = 10) -> tuple[int, int]:
        """The reference assembly -errors sequence (ref:
        gt_readjoiner_assembly_error_correction,
        gt_readjoiner_assembly.c:291): p-bubble rounds until dry, then
        dead-end rounds until dry. Returns (bubble_edges,
        deadend_edges) totals."""
        btot = 0
        for _ in range(bubble_rounds):
            r = self.reduce_bubbles()
            btot += r
            if r == 0:
                break
        dtot = 0
        for _ in range(deadend_rounds):
            r = self.reduce_dead_paths(deadend_depth)
            dtot += r
            if r == 0:
                break
        return btot, dtot

    def spell_contigs(self, min_depth: int = 1, min_length: int = 0,
                      return_paths: bool = False):
        """Unitig spelling (ref: gt_strgraph_spell, rdj-strgraph.c:2760):
        follow maximal paths through vertices with unique continuation.
        Returns list of (seq_str, depth, path_desc)."""
        alpha = dna_alphabet()
        rs = self.readset
        blob, st_, ln_ = rs.blob, rs.starts, rs.lens
        rcb = rs.rcblob if self.edges else blob

        def read_seq(r, strand):
            s = int(st_[r])
            return (blob if strand else rcb)[s:s + int(ln_[r])]

        # vertex-packed (read*2 + strand) edge planes sorted by source:
        # out-sets and degree counts come from searchsorted/bincount
        # instead of per-edge dict builds
        ea, eb, el = self._edge_arrays()
        order = np.argsort(ea, kind="stable")
        sa_, sb_, sl_ = ea[order], eb[order], el[order]
        n = self.readset.num_reads
        indeg = np.bincount(eb, minlength=2 * n) if eb.size else \
            np.zeros(2 * n, np.int64)
        outdeg = np.bincount(ea, minlength=2 * n) if ea.size else \
            np.zeros(2 * n, np.int64)

        # per-vertex out-run bounds, one vectorized pass
        runs = np.searchsorted(sa_, np.arange(2 * n + 1))
        if not return_paths and self.edges:
            from ..core.native import strgraph_spell_native
            res = strgraph_spell_native(
                sb_, sl_, runs, indeg, 2 * n, blob, rcb, st_, ln_,
                min_depth, min_length)
            if res is not None:
                cb, cl, cd, csv, cev = res
                out = []
                off = 0
                for i in range(cl.size):
                    seq = cb[off:off + int(cl[i])]
                    off += int(cl[i])
                    sv, ev = int(csv[i]), int(cev[i])
                    desc = (f"{sv >> 1}{'E' if sv & 1 else 'B'}-->"
                            f"{ev >> 1}{'E' if ev & 1 else 'B'}")
                    out.append((alpha.decode(seq), int(cd[i]), desc))
                return out
        sbl = sb_.tolist()
        sll = sl_.tolist()
        runl = runs.tolist()
        indl = indeg.tolist()

        def out_edges_of(v):
            key = v[0] * 2 + v[1]
            return [(sbl[i] >> 1, bool(sbl[i] & 1), sll[i])
                    for i in range(runl[key], runl[key + 1])]

        def in_count_of(v):
            return indl[v[0] * 2 + v[1]]

        used = set()
        contigs = []
        # path starts: vertices with no unique predecessor
        startv = np.flatnonzero((indeg != 1) & (outdeg >= 1))
        # original visit order per read: strand True before False
        startv = startv[np.argsort((startv >> 1) * 2 + (1 - (startv & 1)),
                                   kind="stable")]
        starts = [(int(k) >> 1, bool(k & 1)) for k in startv]
        for v0 in starts:
            if v0[0] in used:
                continue
            path = [v0]
            lens = []
            v = v0
            while True:
                outs = out_edges_of(v)
                outs = [o for o in outs if o[0] not in used and
                        o[0] != v[0]]
                if len(outs) != 1:
                    break
                b, sb, l = outs[0]
                if in_count_of((b, sb)) != 1:
                    break
                path.append((b, sb))
                lens.append(l)
                used.add(v[0])
                v = (b, sb)
            used.update(p[0] for p in path)
            if len(path) < 2:
                continue
            parts = [read_seq(*path[0])]
            for (b, sb), l in zip(path[1:], lens):
                parts.append(read_seq(b, sb)[l:])
            seq = np.concatenate(parts)
            desc = f"{path[0][0]}{'E' if path[0][1] else 'B'}-->" \
                   f"{path[-1][0]}{'E' if path[-1][1] else 'B'}"
            if len(path) >= min_depth and seq.size >= min_length:
                if return_paths:
                    contigs.append((alpha.decode(seq), len(path), desc,
                                    list(path)))
                else:
                    contigs.append((alpha.decode(seq), len(path), desc))
        return contigs


def assemble(paths: list[str], minlen: int = 5,
             min_depth: int = 2, min_length: int = 0, device="cuda"):
    """Full pipeline: prefilter -> overlap -> assembly. Returns contig
    FASTA (list of (header, seq))."""
    rs = ReadSet.from_files(paths)
    contained = find_contained(rs, device=device)
    keep = [r for r, c in zip(rs.reads, contained) if not c]
    rs2 = ReadSet(keep)
    spms = find_spms(rs2, minlen)
    g = StringGraph.from_spms(rs2, spms)
    g.reduce_self()
    g.reduce_transitive()
    contigs = g.spell_contigs(min_depth=min_depth, min_length=min_length)
    out = []
    for i, (seq, depth, desc) in enumerate(contigs):
        out.append((f"contig_{i} length={len(seq)} depth={depth} {desc}",
                    seq))
    return out


# ---------------------------------------------------------------------------
# contigs graph (ref: src/match/rdj-contigs-graph.c, `gt readjoiner
# cgraph`): a higher-level graph whose nodes are the spelled contigs and
# whose edges are the junction links the unitig spelling stopped at
# ---------------------------------------------------------------------------

@dataclass
class ContigsGraph:
    """Nodes: contigs (sequence + read path); edges: (ci, cj, L) —
    contig ci's end read links into contig cj's start read with overlap
    L in the reduced string graph. The reference builds this from the
    contig-junction link files the assembly phase writes
    (rdj-contigs-graph.c gt_contigs_graph_new); here it is built
    directly from the reduced string graph + contig paths."""

    seqs: list
    paths: list
    edges: list
    deleted: set = field(default_factory=set)

    @classmethod
    def from_assembly(cls, readset: ReadSet, spms: SpmList,
                      min_depth: int = 1) -> "ContigsGraph":
        g = StringGraph.from_spms(readset, spms)
        g.reduce_self()
        g.reduce_transitive()
        contigs = g.spell_contigs(min_depth=min_depth, return_paths=True)
        seqs = [c[0] for c in contigs]
        paths = [c[3] for c in contigs]
        first = {p[0]: i for i, p in enumerate(paths)}
        last = {p[-1]: i for i, p in enumerate(paths)}
        edges = []
        for a, sa, b, sb, l in g.edges:
            ci = last.get((a, sa))
            cj = first.get((b, sb))
            if ci is not None and cj is not None and ci != cj:
                edges.append((ci, cj, int(l)))
        return cls(seqs, paths, sorted(set(edges)))

    def simplify(self) -> int:
        """Extend contigs through unambiguous junctions (the
        capability of gt_contigs_graph_simplify + extend_contigs):
        an edge ci->cj that is ci's only outgoing and cj's only
        incoming merges cj into ci. Returns the number of merges."""
        merges = 0
        changed = True
        while changed:
            changed = False
            outdeg = {}
            indeg = {}
            for ci, cj, l in self.edges:
                if ci in self.deleted or cj in self.deleted:
                    continue
                outdeg[ci] = outdeg.get(ci, 0) + 1
                indeg[cj] = indeg.get(cj, 0) + 1
            for ci, cj, l in list(self.edges):
                if ci in self.deleted or cj in self.deleted or ci == cj:
                    continue
                if outdeg.get(ci) == 1 and indeg.get(cj) == 1:
                    self.seqs[ci] = self.seqs[ci] + self.seqs[cj][l:]
                    self.paths[ci] = self.paths[ci] + self.paths[cj]
                    self.edges = [
                        (a if a != cj else ci, b if b != cj else ci, L)
                        for a, b, L in self.edges
                        if not (a == ci and b == cj and L == l)]
                    self.deleted.add(cj)
                    merges += 1
                    changed = True
                    break
        return merges

    def show_dot(self) -> str:
        out = ["digraph ContigsGraph {"]
        for i, s in enumerate(self.seqs):
            if i in self.deleted:
                continue
            out.append(f'  c{i} [label="c{i} ({len(s)}bp, '
                       f'{len(self.paths[i])} reads)"];')
        for ci, cj, l in self.edges:
            if ci in self.deleted or cj in self.deleted:
                continue
            out.append(f'  c{ci} -> c{cj} [label="{l}"];')
        out.append("}")
        return "\n".join(out) + "\n"

    def output_paths(self) -> list[str]:
        out = []
        for i, p in enumerate(self.paths):
            if i in self.deleted:
                continue
            out.append(f"contig_{i}: " + " ".join(
                f"{r}{'E' if s else 'B'}" for r, s in p))
        return out


# ---------------------------------------------------------------------------
# graph output formats (ref: src/match/gfa_writer.c, asqg_writer.c)
# ---------------------------------------------------------------------------

def write_gfa(readset: ReadSet, spms: SpmList, version: int = 1) -> str:
    """GFA1/GFA2 rendering of the overlap graph (ref: gfa_writer.c)."""
    alpha = dna_alphabet()
    lines = []
    if version == 1:
        lines.append("H\tVN:Z:1.0")
    else:
        lines.append("H\tVN:Z:2.0")
    for i, r in enumerate(readset.reads):
        seq = alpha.decode(r)
        if version == 1:
            lines.append(f"S\t{i}\t{seq}")
        else:
            lines.append(f"S\t{i}\t{len(r)}\t{seq}")
    for sr, ss, pr, ps, l in zip(spms.suf_read, spms.suf_strand,
                                 spms.pref_read, spms.pref_strand,
                                 spms.length):
        o1 = "+" if ss else "-"
        o2 = "+" if ps else "-"
        if version == 1:
            lines.append(f"L\t{sr}\t{o1}\t{pr}\t{o2}\t{l}M")
        else:
            la = len(readset.reads[sr])
            lines.append(f"E\t*\t{sr}{o1}\t{pr}{o2}\t{la - l}\t{la}$"
                         f"\t0\t{l}\t{l}M")
    return "\n".join(lines) + "\n"


def write_asqg(readset: ReadSet, spms: SpmList) -> str:
    """ASQG (SGA) rendering (ref: asqg_writer.c)."""
    alpha = dna_alphabet()
    lines = ["HT\tVN:i:1\tER:f:0"]
    for i, r in enumerate(readset.reads):
        lines.append(f"VT\t{i}\t{alpha.decode(r)}")
    for sr, ss, pr, ps, l in zip(spms.suf_read, spms.suf_strand,
                                 spms.pref_read, spms.pref_strand,
                                 spms.length):
        la = len(readset.reads[sr])
        lb = len(readset.reads[pr])
        rc = 0 if (ss == ps) else 1
        lines.append(f"ED\t{sr} {pr} {la - l} {la - 1} {la} 0 {l - 1} "
                     f"{lb} {rc} -1")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# k-mer spectrum error correction
# (ref: gt readjoiner correct / gt dev seqcorrect, src/match/rdj-errfind.c)
# ---------------------------------------------------------------------------

def correct_reads(readset: ReadSet, k: int = 15, min_count: int = 3,
                  max_corrections: int = 3) -> tuple[ReadSet, int]:
    """Correct sequencing errors using the k-mer spectrum: a position
    covered only by rare k-mers is tried with each substitution; the base
    making its covering k-mers frequent wins. Returns (corrected set,
    number of corrected positions)."""
    # count k-mers over both strands
    from collections import Counter
    counts: Counter = Counter()
    for r in range(readset.num_reads):
        for seq in (readset.reads[r], readset.rc(r)):
            w = _window_codes(seq, k)
            counts.update(w.tolist())

    def kmer_ok(code: int) -> bool:
        return counts[code] >= min_count

    corrected = 0
    out_reads = []
    for r in range(readset.num_reads):
        seq = readset.reads[r].copy()
        if seq.size < k:
            out_reads.append(seq)
            continue
        fixes = 0
        w = _window_codes(seq, k)
        rare = np.array([not kmer_ok(int(c)) for c in w])
        pos = 0
        while pos < seq.size and fixes < max_corrections:
            # position covered exclusively by rare kmers?
            lo = max(0, pos - k + 1)
            hi = min(w.size, pos + 1)
            if hi <= lo or not rare[lo:hi].all():
                pos += 1
                continue
            orig = seq[pos]
            best = None
            for cand in range(4):
                if cand == orig:
                    continue
                seq[pos] = cand
                wl = _window_codes(seq[max(0, pos - k + 1):pos + k], k)
                if all(kmer_ok(int(c)) for c in wl):
                    best = cand
                    break
            if best is not None:
                seq[pos] = best
                fixes += 1
                corrected += 1
                w = _window_codes(seq, k)
                rare = np.array([not kmer_ok(int(c)) for c in w])
            else:
                seq[pos] = orig
            pos += 1
        out_reads.append(seq)
    return ReadSet(out_reads), corrected
