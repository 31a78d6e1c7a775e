"""Reference GtEncseq on-disk formats: .esq / .ssp / .des / .sds / .md5.

The port's copy of ``genometools_tpu/core/esq.py``
(JAX-free host code; the port imports nothing of the reference
package).

Byte-exact read/write of the version-3 encoded-sequence file the `gt`
binary produces and consumes (verified by tests/test_esq_refparity.py
against files written by the compiled reference binary):

* header mapspec: ref src/core/encseq.c:1195
  (gt_encseq_assign_header_mapspec) — every mapspec section is padded to
  8 bytes (ref: src/core/mapspec.c gt_mapspec_pad)
* GtSpecialcharinfo: 14 GtUwords (ref: src/core/chardef.h:91-116)
* access types (ref: src/core/encseq_access_type.c wpa[]):
  0 direct, 1 bytecompress, 2 eqlen, 3 bit, 4 uchar, 5 ushort, 6 uint32;
  DNA picks the smallest representation (determinesmallestrep)
* two-bit encoding: 32 symbols per 64-bit word, first symbol in the most
  significant bits; wildcards stored as 0, separators as
  GT_TWOBITS_FOR_SEPARATOR == 1 (ref: encseq.c:104,2827);
  units = max(2, 2 + (total-1)//32) (ref: intbits.h
  gt_unitsoftwobitencoding)
* BITACCESS specialbits: 1 bit per position MSB-first in 64-bit words,
  ceil((total+64)/64) words, with the 64 bits after position total-1 set
  (ref: encseq.c GT_NUMOFINTSFORBITS allocation + sentinel fill)
* SWtable (wildcard ranges in .esq, separator positions in .ssp):
  page size maxrangevalue+1; positions page-relative; rangelengths store
  len-1 with ranges split into chunks of maxrangevalue+1; endidxinpage[p]
  = number of entries at/before the end of page p, numofpages =
  total//maxrangevalue + 1 (ref: encseq.c initSWtable:1738,
  accspecialrange.gen, ssptaboutinfo_*:1841-1910)
* .des: per finished sequence its description + "\n", then uint64
  (longest description length) and uint64 ~0 (ref: encseq.c:5613-5622,
  encseq_charproc.gen:118-128)
* .sds: one uint64 per separator = .des file offset right after the
  description of the finished sequence
* .md5: 33 bytes per sequence — md5 hex of the UPPERCASED original
  characters + NUL (ref: encseq.c md5 block handling)
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .alphabet import dna_alphabet
from .chardef import SEPARATOR, WILDCARD, is_special
from .encseq import Encseq, _runs

GT_ENCSEQ_VERSION = 3

SAT_DIRECT = 0
SAT_BYTECOMPRESS = 1
SAT_EQUALLENGTH = 2
SAT_BITACCESS = 3
SAT_UCHAR = 4
SAT_USHORT = 5
SAT_UINT32 = 6

_SW_MAX = {SAT_UCHAR: 0xFF, SAT_USHORT: 0xFFFF, SAT_UINT32: 0xFFFFFFFF}
_SW_DTYPE = {SAT_UCHAR: np.uint8, SAT_USHORT: np.uint16,
             SAT_UINT32: np.uint32}


def _pad8(n: int) -> int:
    return (8 - n % 8) % 8


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []
        self.off = 0

    def add(self, raw: bytes):
        """One mapspec section: payload + pad to 8 (mapspec.c:350)."""
        self.parts.append(raw)
        self.off += len(raw)
        p = _pad8(self.off)
        if p:
            self.parts.append(b"\0" * p)
            self.off += p

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, nbytes: int) -> bytes:
        raw = self.buf[self.off:self.off + nbytes]
        self.off += nbytes + _pad8(nbytes)
        return raw

    def u64(self, n: int = 1) -> np.ndarray:
        return np.frombuffer(self.take(8 * n), np.uint64, n)


# ---------------------------------------------------------------------------
# range arithmetic (ref: currentspecialrangevalue, encseq.c:5061)
# ---------------------------------------------------------------------------

def _stored_ranges(lengths: np.ndarray, maxval: int) -> int:
    """Number of stored SWtable entries for real ranges of these lengths:
    a range of length L splits into ceil(L / (maxval+1)) chunks."""
    if lengths.size == 0:
        return 0
    return int(((lengths + maxval) // (maxval + 1)).sum())


def _split_ranges(starts: np.ndarray, lengths: np.ndarray, maxval: int):
    """Split real ranges into stored chunks of length <= maxval+1.
    Returns (chunk_start, chunk_len) arrays in position order."""
    cs, cl = [], []
    for s, l in zip(starts.tolist(), lengths.tolist()):
        while l > maxval + 1:
            cs.append(s)
            cl.append(maxval + 1)
            s += maxval + 1
            l -= maxval + 1
        cs.append(s)
        cl.append(l)
    return np.asarray(cs, np.int64), np.asarray(cl, np.int64)


def _swtable_bytes(sat: int, total: int, starts: np.ndarray,
                   lengths: np.ndarray, with_lengths: bool) -> list[bytes]:
    """Serialize an SWtable (positions[, rangelengths], endidxinpage)."""
    maxval = _SW_MAX[sat]
    dt = _SW_DTYPE[sat]
    cs, cl = _split_ranges(starts, lengths, maxval)
    out = []
    if cs.size:
        out.append((cs & maxval).astype(dt).tobytes())
        if with_lengths:
            out.append((cl - 1).astype(dt).tobytes())
        numofpages = total // maxval + 1
        # endidxinpage[p] = entries with start <= end of page p
        pageend = (np.arange(numofpages, dtype=np.int64) + 1) \
            * (maxval + 1) - 1
        endidx = np.searchsorted(cs, pageend, side="right")
        out.append(endidx.astype(np.uint64).tobytes())
    return out


def _swtable_size(sat: int, total: int, items: int,
                  with_lengths: bool) -> int:
    """ref: gt_encseq_sizeofSWtable (encseq.c:930), unpadded."""
    if items == 0:
        return 0
    maxval = _SW_MAX[sat]
    unit = np.dtype(_SW_DTYPE[sat]).itemsize
    return (2 if with_lengths else 1) * unit * items \
        + 8 * (total // maxval + 1)


def _parse_swtable(r: _Reader, sat: int, total: int, items: int,
                   with_lengths: bool):
    """Inverse of _swtable_bytes. Returns (starts, lengths) absolute."""
    if items == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    maxval = _SW_MAX[sat]
    dt = _SW_DTYPE[sat]
    unit = np.dtype(dt).itemsize
    positions = np.frombuffer(r.take(unit * items), dt).astype(np.int64)
    if with_lengths:
        rangelengths = np.frombuffer(r.take(unit * items), dt)\
            .astype(np.int64) + 1
    else:
        rangelengths = np.ones(items, np.int64)
    numofpages = total // maxval + 1
    endidx = np.frombuffer(r.take(8 * numofpages), np.uint64)\
        .astype(np.int64)
    # page of entry i = first page whose endidx covers i
    page = np.searchsorted(endidx, np.arange(items), side="right")
    starts = positions + page * (maxval + 1)
    return starts, rangelengths


# ---------------------------------------------------------------------------
# twobit encoding
# ---------------------------------------------------------------------------

def _units_of_twobitencoding(total: int) -> int:
    if total < 32:
        return 2
    return 2 + (total - 1) // 32


def _twobit_encode(codes: np.ndarray, sepval: int, wcval: int) -> np.ndarray:
    """uint64 words, 32 symbols each, first symbol in the MSBs. Special
    positions store sat-dependent filler values: BITACCESS puts
    GT_TWOBITS_FOR_SEPARATOR (1) at separators and 0 at wildcards
    (ref: encseq.c:2827 fillViabitaccess); EQUALLENGTH and the via-table
    sats put the least probable character — argmin of the character
    distribution, first minimum — at every special (ref: encseq.c:2599
    fillViaequallength, accspecialrange.gen:233,
    determineleastprobablecharacter encseq.c:4468)."""
    n = codes.size
    units = _units_of_twobitencoding(n)
    sym = np.where(codes == SEPARATOR, np.uint8(sepval),
                   np.where(codes == WILDCARD, np.uint8(wcval), codes))
    padded = np.zeros(units * 32, np.uint8)
    padded[:n] = sym
    # pack 4 symbols/byte (first in the high bits), then flip each
    # 8-byte group so the little-endian uint64 view yields words with
    # the first symbol in the MSBs — all uint8 passes, ~20x faster than
    # the uint64 broadcast-shift formulation at 32Mbp
    q = padded.reshape(-1, 4)
    b = ((q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3])
    return np.ascontiguousarray(
        b.reshape(-1, 8)[:, ::-1]).reshape(-1).view(np.uint64)


_TWOBIT_LUT = np.empty((256, 4), np.uint8)
for _b in range(256):
    _TWOBIT_LUT[_b] = [(_b >> 6) & 3, (_b >> 4) & 3, (_b >> 2) & 3, _b & 3]


def _twobit_decode(words: np.ndarray, total: int) -> np.ndarray:
    # threaded native LUT decode; numpy fallback: all-uint8 passes
    # (byte un-flip + 256x4 LUT)
    if total > (1 << 20):
        from .native import twobit_decode_native
        out = twobit_decode_native(words, total)
        if out is not None:
            return out
    raw = np.ascontiguousarray(
        words.view(np.uint8).reshape(-1, 8)[:, ::-1]).reshape(-1)
    return _TWOBIT_LUT[raw].reshape(-1)[:total]


# ---------------------------------------------------------------------------
# sizes and access-type choice
# ---------------------------------------------------------------------------

def _header_size(numofchars: int, numofdbfiles: int,
                 lengthofdbfilenames: int, lengthofalphadef: int) -> int:
    """Unpadded header byte count (ref: gt_encseq_determine_size tail)."""
    return (1 + 8 * 6 + 14 * 8 + 8 * 4 + lengthofalphadef
            + lengthofdbfilenames + 1 + 8 + 16 * numofdbfiles
            + 8 * numofchars)


def _determine_size(sat: int, total: int, nseq: int, nfiles: int,
                    lenfn: int, wildcardranges: int, numofchars: int,
                    lenalphadef: int) -> int:
    """ref: gt_encseq_determine_size (encseq.c:5149), unpadded sum used
    only for comparisons so padding cancellation is irrelevant."""
    two = 8 * _units_of_twobitencoding(total)
    if sat == SAT_EQUALLENGTH:
        body = two
    elif sat == SAT_BITACCESS:
        body = two
        if wildcardranges > 0 or nseq > 1:
            body += 8 * ((total + 64 + 63) // 64)
    elif sat in _SW_MAX:
        body = two + _swtable_size(sat, total, wildcardranges, True)
    else:
        raise NotImplementedError(f"sat {sat}")
    return body + _header_size(numofchars, nfiles, lenfn, lenalphadef)


def determine_sat(enc: Encseq, nfiles: int, lenfn: int,
                  lenalphadef: int = 0) -> int:
    """DNA access-type choice (ref: determinesmallestrep,
    src/core/encseq_access_type.c:97)."""
    total = enc.total_length
    nseq = enc.num_sequences
    wstarts, wlens = (enc.wildcard_ranges.starts,
                      enc.wildcard_ranges.lengths)
    eqlen = _equal_length(enc) is not None and wstarts.size == 0
    if eqlen:
        return SAT_EQUALLENGTH
    best_sat = SAT_BITACCESS
    best = _determine_size(SAT_BITACCESS, total, nseq, nfiles, lenfn,
                           _stored_ranges(wlens, 0xFF), 4, lenalphadef)
    for sat in (SAT_UCHAR, SAT_USHORT, SAT_UINT32):
        sz = _determine_size(sat, total, nseq, nfiles, lenfn,
                             _stored_ranges(wlens, _SW_MAX[sat]), 4,
                             lenalphadef)
        if sz < best:
            best = sz
            best_sat = sat
    return best_sat


def _equal_length(enc: Encseq) -> int | None:
    """Common sequence length, or None (ref: equallength.defined —
    all sequences equal length AND no specials besides separators)."""
    if enc.num_sequences == 0:
        return None
    lens = enc.seq_length(np.arange(enc.num_sequences))
    if np.unique(lens).size != 1:
        return None
    if enc.special_ranges.total != enc.num_sequences - 1:
        return None
    return int(lens[0])


# ---------------------------------------------------------------------------
# specialcharinfo (ref: chardef.h:91-116)
# ---------------------------------------------------------------------------

def _specialcharinfo(enc: Encseq, sat: int) -> list[int]:
    codes = enc.codes
    n = codes.size
    sstarts, slens = enc.special_ranges.starts, enc.special_ranges.lengths
    wstarts, wlens = enc.wildcard_ranges.starts, enc.wildcard_ranges.lengths
    # stored range counts depend on the chosen representation; non-table
    # sats record the uchar-rep counts (specialrangestab[0], ref:
    # gt_encseq_access_type_determine:148)
    maxval = _SW_MAX.get(sat, 0xFF)
    lspre = int(slens[0]) if sstarts.size and sstarts[0] == 0 else 0
    lssuf = int(slens[-1]) if sstarts.size \
        and sstarts[-1] + slens[-1] == n else 0
    lwpre = int(wlens[0]) if wstarts.size and wstarts[0] == 0 else 0
    lwsuf = int(wlens[-1]) if wstarts.size \
        and wstarts[-1] + wlens[-1] == n else 0
    # longest nonspecial stretch = largest gap between special runs
    # (deriving it from the run table avoids materializing the ~33M
    # position list flatnonzero(~sp) would produce on big inputs)
    if sstarts.size:
        stretch = np.concatenate([sstarts, [n]]) - \
            np.concatenate([[0], sstarts + slens])
        longest = int(stretch.max())
    else:
        longest = n if n else 0
    return [int(slens.sum()) if slens.size else 0,
            _stored_ranges(slens, maxval),
            int(sstarts.size),
            lspre, lssuf,
            int(wlens.sum()) if wlens.size else 0,
            _stored_ranges(wlens, maxval),
            int(wstarts.size),
            lwpre, lwsuf,
            longest,
            0, 0, 0]


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def write_esq(enc: Encseq, indexname: str, sat: int | None = None) -> int:
    """Write <indexname>.esq (+ .ssp when needed) in the reference
    format. Returns the chosen access type."""
    if enc.alphabet.num_chars != 4:
        raise NotImplementedError("reference .esq writer: DNA only")
    origin = enc.origin
    filenames = (origin.filenames if origin and origin.filenames
                 else [indexname])
    lenfn = sum(len(f) + 1 for f in filenames)
    if sat is None:
        sat = determine_sat(enc, len(filenames), lenfn)
    total = enc.total_length
    nseq = enc.num_sequences

    w = _Writer()
    w.add(b"\1")                                        # is64bit
    for v in (GT_ENCSEQ_VERSION, sat, total, nseq, len(filenames), lenfn):
        w.add(np.uint64(v).tobytes())
    w.add(np.asarray(_specialcharinfo(enc, sat), np.uint64).tobytes())
    lens = enc.seq_length(np.arange(nseq)) if nseq else np.zeros(1)
    w.add(np.uint64(lens.min() if nseq else 0).tobytes())   # minseqlen
    w.add(np.uint64(lens.max() if nseq else 0).tobytes())   # maxseqlen
    w.add(np.uint64(0).tobytes())                       # alphatype 0 = DNA
    w.add(np.uint64(0).tobytes())                       # lengthofalphadef
    w.add(b"")                                          # alphadef (empty)
    w.add(b"".join(f.encode() + b"\0" for f in filenames))
    w.add(np.uint8(origin.maxsubalphasize if origin else 1).tobytes())
    w.add(np.uint64(origin.numofallchars if origin else 4).tobytes())
    if origin and origin.filelengths:
        flt = np.asarray(origin.filelengths, np.uint64)
    else:
        flt = np.asarray([[total, total]], np.uint64)
    w.add(flt.tobytes())
    dist = np.bincount(enc.codes, minlength=256)[:4]   # specials are >= 253
    w.add(dist.astype(np.uint64).tobytes())

    # sequence body
    lpc = int(np.argmin(dist))
    if sat == SAT_BITACCESS:
        sepval, wcval = 1, 0
    else:
        sepval = wcval = lpc
    w.add(_twobit_encode(enc.codes, sepval, wcval).tobytes())
    wstarts, wlens = (enc.wildcard_ranges.starts,
                      enc.wildcard_ranges.lengths)
    if sat == SAT_BITACCESS:
        if wstarts.size > 0 or nseq > 1:
            nwords = (total + 64 + 63) // 64
            bits = np.zeros(nwords * 64, bool)
            bits[:total] = is_special(enc.codes)
            bits[total:total + 64] = True               # sentinel block
            words = np.packbits(bits).view(">u8").astype(np.uint64)
            w.add(words.tobytes())
    elif sat in _SW_MAX:
        for raw in _swtable_bytes(sat, total, wstarts, wlens, True):
            w.add(raw)
    elif sat != SAT_EQUALLENGTH:
        raise NotImplementedError(f"sat {sat}")
    Path(indexname + ".esq").write_bytes(w.getvalue())

    if nseq > 1 and sat != SAT_EQUALLENGTH:
        write_ssp(enc, indexname)
    return sat


def _ssp_sat(total: int, numofseparators: int) -> int:
    """ref: determineoptimalsssptablerep (encseq.c:1714)."""
    best_sat, best = SAT_UCHAR, _swtable_size(SAT_UCHAR, total,
                                              numofseparators, False)
    for sat in (SAT_USHORT, SAT_UINT32):
        sz = _swtable_size(sat, total, numofseparators, False)
        if sz < best:
            best, best_sat = sz, sat
    return best_sat


def write_ssp(enc: Encseq, indexname: str) -> None:
    total = enc.total_length
    seps = enc.ssp
    sat = _ssp_sat(total, seps.size)
    w = _Writer()
    for raw in _swtable_bytes(sat, total, seps.astype(np.int64),
                              np.ones(seps.size, np.int64), False):
        w.add(raw)
    Path(indexname + ".ssp").write_bytes(w.getvalue())


def write_des_sds(enc: Encseq, indexname: str) -> None:
    """ref: encseq_charproc.gen:118-128 + encseq.c:5613-5622."""
    des = bytearray()
    sds = []
    for i, d in enumerate(enc.descs):
        des += d.encode()
        if i < len(enc.descs) - 1:
            sds.append(len(des))
        des += b"\n"
    longest = max((len(d) for d in enc.descs), default=0)
    des += np.uint64(longest).tobytes()
    des += b"\xff" * 8
    Path(indexname + ".des").write_bytes(bytes(des))
    Path(indexname + ".sds").write_bytes(
        np.asarray(sds, np.uint64).tobytes())


def write_md5(enc: Encseq, indexname: str) -> None:
    if enc.origin is None or len(enc.origin.md5s) != enc.num_sequences:
        raise ValueError("md5 provenance unavailable")
    raw = b"".join(m.encode() + b"\0" for m in enc.origin.md5s)
    Path(indexname + ".md5").write_bytes(raw)


def write_all(enc: Encseq, indexname: str) -> int:
    """.esq (+.ssp) + .des/.sds/.md5 — what `gt suffixerator -tis` (with
    default -des/-sds/-md5) materializes."""
    sat = write_esq(enc, indexname)
    write_des_sds(enc, indexname)
    if enc.origin is not None and enc.origin.md5s:
        write_md5(enc, indexname)
    return sat


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

@dataclass
class EsqMeta:
    sat: int
    totallength: int
    numofdbsequences: int
    filenames: list[str]
    specialcharinfo: list[int]
    minseqlen: int
    maxseqlen: int
    characterdistribution: list[int]


def read_esq(indexname: str) -> tuple[Encseq, EsqMeta]:
    """Load a reference-format .esq (+ .ssp) into an Encseq."""
    buf = Path(indexname + ".esq").read_bytes()
    r = _Reader(buf)
    is64 = r.take(1)[0]
    if not is64:
        raise NotImplementedError("32-bit .esq")
    version = int(r.u64()[0])
    if version != GT_ENCSEQ_VERSION:
        raise ValueError(f"unsupported .esq version {version}")
    sat = int(r.u64()[0])
    total = int(r.u64()[0])
    nseq = int(r.u64()[0])
    nfiles = int(r.u64()[0])
    lenfn = int(r.u64()[0])
    sci = r.u64(14).astype(np.int64).tolist()
    minl = int(r.u64()[0])
    maxl = int(r.u64()[0])
    alphatype = int(r.u64()[0])
    lenalphadef = int(r.u64()[0])
    r.take(lenalphadef)                                 # alphadef
    fn = r.take(lenfn)
    filenames = [f.decode() for f in fn.split(b"\0") if f]
    r.take(1)                                           # maxsubalphasize
    r.u64()                                             # numofallchars
    r.u64(2 * nfiles)                                   # filelengthtab
    chardist = r.u64(4 if alphatype == 0 else 20).astype(np.int64)
    if alphatype != 0:
        raise NotImplementedError("only DNA .esq supported")

    units = _units_of_twobitencoding(total)
    words = np.frombuffer(r.take(8 * units), np.uint64)
    codes = _twobit_decode(words, total)

    if sat == SAT_EQUALLENGTH:
        if nseq > 1:
            eql = (total - (nseq - 1)) // nseq
            seps = (np.arange(1, nseq, dtype=np.int64)) * (eql + 1) - 1
        else:
            seps = np.zeros(0, np.int64)
        codes[seps] = SEPARATOR
    elif sat == SAT_BITACCESS:
        wildcardranges = sci[6]
        if wildcardranges > 0 or nseq > 1:
            nwords = (total + 64 + 63) // 64
            words = np.frombuffer(r.take(8 * nwords), np.uint64)
            bits = np.unpackbits(
                words.astype(">u8").view(np.uint8))[:total].astype(bool)
            sep = bits & (codes == 1)
            wc = bits & (codes == 0)
            codes[wc] = WILDCARD
            codes[sep] = SEPARATOR
        seps = np.flatnonzero(codes == SEPARATOR).astype(np.int64)
    elif sat in _SW_MAX:
        starts, lens = _parse_swtable(r, sat, total, sci[6], True)
        for s, l in zip(starts.tolist(), lens.tolist()):
            codes[s:s + l] = WILDCARD
        seps = read_ssp(indexname, total, nseq) if nseq > 1 \
            else np.zeros(0, np.int64)
        codes[seps] = SEPARATOR
    else:
        raise NotImplementedError(f"sat {sat}")

    descs = read_des(indexname, nseq)
    enc = Encseq(codes.astype(np.uint8), seps, descs, dna_alphabet())
    meta = EsqMeta(sat, total, nseq, filenames, sci, minl, maxl,
                   chardist.tolist())
    return enc, meta


def read_ssp(indexname: str, total: int, nseq: int) -> np.ndarray:
    sat = _ssp_sat(total, nseq - 1)
    buf = Path(indexname + ".ssp").read_bytes()
    starts, _ = _parse_swtable(_Reader(buf), sat, total, nseq - 1, False)
    return starts


def read_des(indexname: str, nseq: int) -> list[str]:
    p = Path(indexname + ".des")
    if not p.exists():
        return [""] * nseq
    raw = p.read_bytes()[:-16]                         # strip longest+fin
    descs = raw.decode("latin-1").split("\n")
    if descs and descs[-1] == "":
        descs.pop()
    return descs if len(descs) == nseq else [""] * nseq
