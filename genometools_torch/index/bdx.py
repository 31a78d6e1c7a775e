"""Reference packedindex on-disk format (.bdx): reader and writer.

The port's copy of ``genometools_tpu/index/bdx.py`` (JAX-free host
code; the port imports nothing of the reference package).

Decodes the block-composition-encoded BWT index the reference `gt
packedindex mkindex` writes (ref: src/match/eis-blockcomp.c:
writeIdxHeader :1985 / loadBlockEncIdxSeq :2120, composition tables
src/match/eis-seqblocktranslate.c, range encodings
src/match/eis-seqranges.c), so packed indexes gt built can be checked
against the BWT of the port's ESA (``packedindex chkintegrity``).

Layout recap (all bitstrings MSB-first, ref: core/bitpackstring.h:955):

  * header: "BDX\\0" + u32 total header length (rounded to 8192 =
    cwDataPos), then (u32 tag, value) fields — BKSZ block size, BBLK
    blocks/bucket, VOFF varDataPos, ROFF rangeEncPos, SELE seqLen,
    SPBT bitsPerUlong, VDOB bitsPerVarDiskOffset, SSBT blockMap
    alphabet size + per-symbol partialSymSumBits, BEFB/REFB fallbacks,
    NMRN mode list (+ optional CBMB/CEXB/MEXB extension-bit fields).
  * cwData at cwDataPos: per bucket `superBlockCWBits` bits =
    partial symbol sums (cumulative counts BEFORE the bucket)
    + varData bit offset + callback offset + bucketBlocks composition
    indices + cwExt bits.
  * varData at varDataPos: per block, the permutation index
    (permIdxBits depends on that block's composition).
  * block coding: composition index = lexicographic rank of the count
    vector (stars-and-bars order, first composition = all mass on the
    LAST symbol); permutation index = lexicographic rank of the block
    among its multiset permutations.
  * specials (wildcards/separators) are range-encoded at rangeEncPos
    (eis-seqranges) and override the block symbols.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from math import comb

import numpy as np


class BdxError(ValueError):
    pass


class _Bits:
    """MSB-first bit reader over a bytes object."""

    def __init__(self, data: bytes, base_bytes: int = 0):
        self.data = data
        self.base = base_bytes * 8

    def get(self, off: int, nb: int) -> int:
        if nb == 0:
            return 0
        off += self.base
        lo = off // 8
        hi = (off + nb + 7) // 8
        chunk = int.from_bytes(self.data[lo:hi], "big")
        drop = hi * 8 - (off + nb)
        return (chunk >> drop) & ((1 << nb) - 1)


@dataclass
class BdxHeader:
    block_size: int = 0
    bucket_blocks: int = 0
    var_data_pos: int = 0
    range_enc_pos: int = 0
    seq_len: int = 0
    bits_per_ulong: int = 0
    bits_per_var_disk_offset: int = 0
    block_map_alphabet_size: int = 0
    partial_sym_sum_bits: list[int] = field(default_factory=list)
    block_enc_fallback: int = 0
    range_enc_fallback: int = 0
    modes: list[int] = field(default_factory=list)
    callback_offset_bits: int = 0
    cw_ext_bits_per_bucket: int = 0
    max_var_ext_bits_per_bucket: int = 0
    cw_data_pos: int = 0


_TAGS = {
    0x424b535a: "BKSZ", 0x42424c4b: "BBLK", 0x564f4646: "VOFF",
    0x524f4646: "ROFF", 0x4e4d524e: "NMRN", 0x43424d42: "CBMB",
    0x4d455842: "MEXB", 0x43455842: "CEXB", 0x53504254: "SPBT",
    0x53534254: "SSBT", 0x42454642: "BEFB", 0x52454642: "REFB",
    0x56444f42: "VDOB", 0x53454c45: "SELE",
}


def read_header(data: bytes) -> BdxHeader:
    if data[:4] != b"BDX\0":
        raise BdxError("not a .bdx file")
    h = BdxHeader()
    h.cw_data_pos = struct.unpack_from("<I", data, 4)[0]
    off = 8
    end = h.cw_data_pos
    while off + 4 <= end:
        tag = struct.unpack_from("<I", data, off)[0]
        name = _TAGS.get(tag)
        if name is None:
            break
        off += 4
        if name == "BKSZ":
            h.block_size = struct.unpack_from("<I", data, off)[0]
            off += 4
        elif name == "BBLK":
            h.bucket_blocks = struct.unpack_from("<I", data, off)[0]
            off += 4
        elif name == "VOFF":
            h.var_data_pos = struct.unpack_from("<Q", data, off)[0]
            off += 8
        elif name == "ROFF":
            h.range_enc_pos = struct.unpack_from("<Q", data, off)[0]
            off += 8
        elif name == "SELE":
            h.seq_len = struct.unpack_from("<Q", data, off)[0]
            off += 8
        elif name == "SPBT":
            h.bits_per_ulong = struct.unpack_from("<I", data, off)[0]
            off += 4
        elif name == "VDOB":
            h.bits_per_var_disk_offset = \
                struct.unpack_from("<I", data, off)[0]
            off += 4
        elif name == "SSBT":
            n = struct.unpack_from("<I", data, off)[0]
            h.block_map_alphabet_size = n
            off += 4
            h.partial_sym_sum_bits = [
                struct.unpack_from("<I", data, off + 4 * i)[0]
                for i in range(n)]
            off += 4 * n
        elif name == "BEFB":
            h.block_enc_fallback = struct.unpack_from("<I", data, off)[0]
            off += 4
        elif name == "REFB":
            h.range_enc_fallback = struct.unpack_from("<I", data, off)[0]
            off += 4
        elif name == "NMRN":
            n = struct.unpack_from("<I", data, off)[0]
            off += 4
            h.modes = [struct.unpack_from("<I", data, off + 4 * i)[0]
                       for i in range(n)]
            off += 4 * n
        elif name == "CBMB":
            h.callback_offset_bits = \
                struct.unpack_from("<I", data, off)[0]
            off += 4
        elif name == "CEXB":
            h.cw_ext_bits_per_bucket = \
                struct.unpack_from("<Q", data, off)[0]
            off += 8
        elif name == "MEXB":
            h.max_var_ext_bits_per_bucket = \
                struct.unpack_from("<Q", data, off)[0]
            off += 8
    return h


# -- composition / permutation unranking ---------------------------------

def _required_bits(x: int) -> int:
    """gt_requiredUInt64Bits: bits to hold x (>=1 for x=0? callers only
    use x >= 1; bit_length covers both)."""
    return max(1, x.bit_length())


def num_compositions(block_size: int, sigma: int) -> int:
    return comb(block_size + sigma - 1, sigma - 1)


def unrank_composition(idx: int, block_size: int, sigma: int
                       ) -> list[int]:
    """Count vector of composition `idx` in the reference's order:
    lexicographic by (c0..c_{sigma-1}); first = (0,..,0,block_size)."""
    counts = []
    rem = block_size
    for pos in range(sigma - 1):
        syms_left = sigma - pos - 1
        c = 0
        while True:
            # compositions with this prefix: distribute rem-c over
            # syms_left symbols
            n = comb(rem - c + syms_left - 1, syms_left - 1)
            if idx < n:
                break
            idx -= n
            c += 1
        counts.append(c)
        rem -= c
    counts.append(rem)
    return counts


def perm_count(counts: list[int]) -> int:
    from math import factorial
    n = factorial(sum(counts))
    for c in counts:
        n //= factorial(c)
    return n


def perm_idx_bits(counts: list[int]) -> int:
    n = perm_count(counts)
    return _required_bits(n - 1) if n > 1 else 0


def unrank_permutation(idx: int, counts: list[int]) -> list[int]:
    """Symbol sequence of lexicographic rank `idx` among the multiset
    permutations with the given symbol counts."""
    counts = list(counts)
    block = []
    n = sum(counts)
    for _ in range(n):
        for s in range(len(counts)):
            if counts[s] == 0:
                continue
            counts[s] -= 1
            m = perm_count(counts)
            if idx < m:
                block.append(s)
                break
            idx += -m
            counts[s] += 1
    return block


# -- full decode ---------------------------------------------------------

def decode(path: str):
    """Decode a .bdx file: returns (header, block-mapped symbol array
    of seq_len entries, per-bucket partial symbol sums array)."""
    data = open(path, "rb").read()
    h = read_header(data)
    sigma = h.block_map_alphabet_size
    bs = h.block_size
    bucket_len = bs * h.bucket_blocks
    nbuckets = (h.seq_len + bucket_len - 1) // bucket_len
    nblocks = (h.seq_len + bs - 1) // bs
    comp_idx_bits = _required_bits(num_compositions(bs, sigma) - 1)
    sym_sum_bits = sum(h.partial_sym_sum_bits)
    cw_bits = (sym_sum_bits + h.bits_per_var_disk_offset
               + h.callback_offset_bits
               + h.bucket_blocks * comp_idx_bits
               + h.cw_ext_bits_per_bucket)
    cw = _Bits(data, h.cw_data_pos)
    var = _Bits(data, h.var_data_pos)

    out = np.zeros(nbuckets * bucket_len, np.uint8)
    psums = np.zeros((nbuckets, sigma), np.int64)
    for b in range(nbuckets):
        base = b * cw_bits
        o = base
        for s in range(sigma):
            psums[b, s] = cw.get(o, h.partial_sym_sum_bits[s])
            o += h.partial_sym_sum_bits[s]
        var_off = cw.get(o, h.bits_per_var_disk_offset)
        o += h.bits_per_var_disk_offset + h.callback_offset_bits
        vpos = var_off
        blocks_here = min(h.bucket_blocks, nblocks - b * h.bucket_blocks)
        for j in range(blocks_here):
            cidx = cw.get(o, comp_idx_bits)
            o += comp_idx_bits
            counts = unrank_composition(cidx, bs, sigma)
            pbits = perm_idx_bits(counts)
            pidx = var.get(vpos, pbits)
            vpos += pbits
            block = unrank_permutation(pidx, counts)
            p0 = b * bucket_len + j * bs
            out[p0:p0 + bs] = block
    return h, out[:h.seq_len], psums


def read_ranges(data: bytes, h: BdxHeader, sym_bits: int = 1
                ) -> list[tuple[int, int, int]]:
    """Special-symbol ranges at rangeEncPos (ref: gt_SRLSaveToStream,
    eis-seqranges.c:460; struct seqRange eis-seqranges-priv.h:25):
    u64 count, then per range u64 startPos + an 8-byte MSB-first
    bitstring holding symBits of range-alphabet symbol followed by the
    range length. Returns (start, length, range_symbol)."""
    off = h.range_enc_pos
    (n,) = struct.unpack_from("<Q", data, off)
    off += 8
    out = []
    for _ in range(n):
        (start,) = struct.unpack_from("<Q", data, off)
        bits = _Bits(data[off + 8:off + 16])
        sym = bits.get(0, sym_bits)
        length = bits.get(sym_bits, 64 - sym_bits)
        out.append((start, length, sym))
        off += 16
    return out


def decode_bwt(path: str, wildcard: int = 254, separator: int = 255
               ) -> np.ndarray:
    """Full BWT recovery from a reference .bdx: block-decoded regular
    symbols with the special ranges overlaid (range symbol 0 ->
    wildcard/UNDEFBWTCHAR, 1 -> separator)."""
    data = open(path, "rb").read()
    h, syms, _ = decode(path)
    out = syms.astype(np.int16)
    for start, length, sym in read_ranges(data, h):
        if start >= h.seq_len:
            continue          # construction junk / sentinel tail range
        end = min(start + length, h.seq_len)
        out[start:end] = wildcard if sym == 0 else separator
    return out


# -- writer --------------------------------------------------------------

class _BitWriter:
    """MSB-first bit accumulator."""

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nb = 0

    def put(self, value: int, nb: int):
        if nb == 0:
            return
        self.acc = (self.acc << nb) | (value & ((1 << nb) - 1))
        self.nb += nb
        while self.nb >= 8:
            self.nb -= 8
            self.buf.append((self.acc >> self.nb) & 0xFF)
        self.acc &= (1 << self.nb) - 1

    def getvalue(self) -> bytes:
        out = bytes(self.buf)
        if self.nb:
            out += bytes([(self.acc << (8 - self.nb)) & 0xFF])
        return out

    @property
    def bitpos(self) -> int:
        return len(self.buf) * 8 + self.nb


def rank_composition(counts: list[int]) -> int:
    """Inverse of unrank_composition."""
    sigma = len(counts)
    rem = sum(counts)
    idx = 0
    for pos in range(sigma - 1):
        syms_left = sigma - pos - 1
        for c in range(counts[pos]):
            idx += comb(rem - c + syms_left - 1, syms_left - 1)
        rem -= counts[pos]
    return idx


def rank_permutation(block: list[int], sigma: int) -> int:
    """Inverse of unrank_permutation (lexicographic multiset rank)."""
    counts = [0] * sigma
    for s in block:
        counts[s] += 1
    idx = 0
    for i, s in enumerate(block):
        for t in range(s):
            if counts[t] == 0:
                continue
            counts[t] -= 1
            idx += perm_count(counts)
            counts[t] += 1
        counts[s] -= 1
    return idx


def write_bdx(path: str, bwt: np.ndarray, char_counts: list[int],
              block_size: int = 8, bucket_blocks: int = 8,
              wildcard: int = 254, separator: int = 255) -> None:
    """Write a reference-format .bdx over a BWT symbol stream (regular
    codes 0..sigma-1 + wildcard/separator/UNDEFBWTCHAR specials), with
    the writeIdxHeader field layout (ref: eis-blockcomp.c:1985), cw/var
    bitstreams (:1712 layout constants) and the seqRange list
    (eis-seqranges.c:460). No locate/context extensions (the
    `-locfreq 0` shape: callBackDataOffsetBits == 0, no extension
    headers). char_counts = per-regular-symbol totals of the UNDERLYING
    sequence (gt_encseq_charcount — defines partialSymSumBits)."""
    sigma = len(char_counts)
    seq_len = int(bwt.size)
    bs = block_size
    bucket_len = bs * bucket_blocks
    nbuckets = (seq_len + 1 + bucket_len - 1) // bucket_len
    comp_idx_bits = _required_bits(num_compositions(bs, sigma) - 1)
    pss_bits = [_required_bits(int(c)) for c in char_counts]
    sym_sum_bits = sum(pss_bits)
    max_perm_bits = max(
        perm_idx_bits(unrank_composition(i, bs, sigma))
        for i in range(num_compositions(bs, sigma)))
    bits_per_vdo = _required_bits(nbuckets * max_perm_bits
                                  * bucket_blocks)
    bits_per_ulong = _required_bits(seq_len)
    cw_bits = (sym_sum_bits + bits_per_vdo
               + bucket_blocks * comp_idx_bits)
    modes = [1, 2]                       # BLOCK for regulars, DIRECT

    # header ------------------------------------------------------------
    hdr = bytearray()
    hdr += b"BDX\0"
    hdr += b"\0\0\0\0"                   # header length placeholder
    def fld(tag, value, wide=False):
        hdr.extend(struct.pack("<I", tag))
        hdr.extend(struct.pack("<Q" if wide else "<I", value))
    inv = {v: k for k, v in _TAGS.items()}
    fld(inv["BKSZ"], bs)
    fld(inv["BBLK"], bucket_blocks)
    voff_at = len(hdr) + 4
    fld(inv["VOFF"], 0, wide=True)       # patched below
    roff_at = len(hdr) + 4
    fld(inv["ROFF"], 0, wide=True)       # patched below
    fld(inv["SELE"], seq_len, wide=True)
    fld(inv["SPBT"], bits_per_ulong)
    fld(inv["VDOB"], bits_per_vdo)
    hdr.extend(struct.pack("<I", inv["SSBT"]))
    hdr.extend(struct.pack("<I", sigma))
    for b in pss_bits:
        hdr.extend(struct.pack("<I", b))
    fld(inv["BEFB"], 0)
    fld(inv["REFB"], 0)
    hdr.extend(struct.pack("<I", inv["NMRN"]))
    hdr.extend(struct.pack("<I", len(modes)))
    for m in modes:
        hdr.extend(struct.pack("<I", m))
    header_len = -(-len(hdr) // 8192) * 8192       # roundUp to 8192
    struct.pack_into("<I", hdr, 4, header_len)

    # blocks + ranges ----------------------------------------------------
    special = bwt >= sigma
    blocksyms = np.where(special, 0, bwt).astype(np.int64)
    nblocks = nbuckets * bucket_blocks
    padded = np.zeros(nblocks * bs, np.int64)
    padded[:seq_len] = blocksyms
    spec_padded = np.zeros(nblocks * bs, bool)
    spec_padded[:seq_len] = special

    cw = _BitWriter()
    var = _BitWriter()
    sums = [0] * sigma
    for b in range(nbuckets):
        for s in range(sigma):
            cw.put(sums[s], pss_bits[s])
        cw.put(var.bitpos, bits_per_vdo)
        for j in range(bucket_blocks):
            p0 = (b * bucket_blocks + j) * bs
            block = padded[p0:p0 + bs].tolist()
            counts = [0] * sigma
            for x, sp in zip(block, spec_padded[p0:p0 + bs]):
                if not sp:
                    counts[x] += 1
            # composition over ALL slots (specials already fallback 0)
            ccounts = [0] * sigma
            for x in block:
                ccounts[x] += 1
            cw.put(rank_composition(ccounts), comp_idx_bits)
            pbits = perm_idx_bits(ccounts)
            if pbits:
                var.put(rank_permutation(block, sigma), pbits)
            for x, sp in zip(block, spec_padded[p0:p0 + bs]):
                if not sp:
                    sums[x] += 1
    cw_bytes = cw.getvalue()
    cw_len = -(-(cw_bits * nbuckets) // 8)
    cw_bytes = cw_bytes.ljust(cw_len, b"\0")
    var_bytes = var.getvalue()

    var_data_pos = header_len + cw_len
    range_enc_pos = var_data_pos + len(var_bytes)
    struct.pack_into("<Q", hdr, voff_at, var_data_pos)
    struct.pack_into("<Q", hdr, roff_at, range_enc_pos)

    # seqRange list: maximal same-symbol special runs ------------------
    ranges = []
    i = 0
    while i < seq_len:
        if special[i]:
            sym = 0 if bwt[i] == wildcard else 1
            j = i
            while j < seq_len and special[j] and \
                    (0 if bwt[j] == wildcard else 1) == sym:
                j += 1
            ranges.append((i, j - i, sym))
            i = j
        else:
            i += 1
    # trailing sentinel: the reference's range walker expects a range
    # at-or-after the tail positions (its own files carry one from the
    # construction's junk tail; without it gt's reader misclassifies
    # positions after the last real range — verified with gt's own
    # chkintegrity). One 1-long wildcard range at seq_len is inert for
    # all queries in [0, seq_len).
    ranges.append((seq_len, 1, 0))
    rng = bytearray(struct.pack("<Q", len(ranges)))
    for start, length, sym in ranges:
        rng += struct.pack("<Q", start)
        w = _BitWriter()
        w.put(sym, 1)
        w.put(length, 63)
        rng += w.getvalue()

    with open(path, "wb") as f:
        f.write(bytes(hdr).ljust(header_len, b"\0"))
        f.write(cw_bytes)
        f.write(var_bytes)
        f.write(bytes(rng))
