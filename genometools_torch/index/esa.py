"""Enhanced suffix array: build entry point and gt-format writers.

Counterpart of ``genometools_tpu/index/esa.py`` (the reference
suffixerator pipeline, ref: src/match/sfx-run.c:428). The suffix sort
runs on the port's device engines (``index/suffix.py``: the packed
pipeline for canonical keys, prefix doubling otherwise), or on a mesh of
devices (``parallel/dist_doubling_sharded``); the derived tables, the
writers and the reader (``read_prj``, ``load_esa``) are the reference's
host numpy code, copied because the reference module imports JAX.
``Encseq`` is the reference's JAX-free class, re-exported here.

On-disk formats (ref: src/match/esa-fileend.h:26-77): .suf — suffix
positions as native-endian words; .lcp — one byte per entry, 255 marks
an overflow stored in .llv as (position, value) word pairs; .bwt;
.prj — key=value project metadata; .bck — bucket tables.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..core.chardef import is_special
from ..core.encseq import FWD, Encseq
from ..core.native import kasai_lcp_native, sais_native
from .suffix import build_suffix_array

LCP_OVERFLOW = 255


def _bcktab_sizeoftable(num_chars: int, prefixlength: int, maxvalue: int,
                        withspecialsuffixes: bool = True) -> int:
    """ref: gt_bcktab_sizeoftable (src/match/bcktab.c:289): leftborder +
    countspecialcodes + distpfxidx counter bytes for a given prefixlength."""
    base = 8 if maxvalue > 0xFFFFFFFF else 4
    size = base * (num_chars ** prefixlength + 1)
    if withspecialsuffixes:
        size += base * num_chars ** (prefixlength - 1)
        if prefixlength > 2:
            size += base * sum(num_chars ** i
                               for i in range(1, prefixlength - 1))
    return size


def recommended_prefixlength(num_chars: int, totallength: int,
                             multiplier: float = 0.25) -> int:
    """ref: gt_recommendedprefixlength (src/match/sfx-apfxlen.c:82):
    largest prefixlength whose bcktab size stays below
    multiplier * totallength bytes (GT_RECOMMENDED_MULTIPLIER_DEFAULT
    0.25), clamped to [1, maxbasepower]. Exact reference arithmetic —
    verified byte-identical .prj vs the compiled gt binary on at1MB."""
    if num_chars <= 1:
        return 1
    pl = 1
    while (_bcktab_sizeoftable(num_chars, pl, totallength + 1) / multiplier
           <= totallength):
        pl += 1
    pl -= 1
    if pl == 0:
        return 1
    # gt_maxbasepower: largest i with num_chars^i < (2^64-1)/num_chars
    minfailure = (2 ** 64 - 1) // num_chars
    mbp, power = 0, 1
    while power < minfailure:
        power *= num_chars
        mbp += 1
    return min(mbp, pl) if mbp >= 1 else pl


@dataclass
class EnhancedSuffixArray:
    encseq: Encseq
    readmode: int
    suftab: np.ndarray                 # int (totallength+1)
    lcptab: np.ndarray | None = None   # int32 (totallength+1)
    prefixlength: int = 0
    bcktab: "Bcktab | None" = None
    # the .lcp file's bytes, capped at 255 (load_esa): enough for
    # consumers that only test lcp < k for k <= 255 (tallymer)
    lcp_small: np.ndarray | None = None

    @property
    def total_length(self) -> int:
        return self.encseq.total_length

    @property
    def longest(self) -> int:
        """Rank of the whole-sequence suffix (ref: .prj key 'longest')."""
        return int(np.nonzero(self.suftab == 0)[0][0]) if self.suftab.size else 0

    def bwt(self) -> np.ndarray:
        """Burrows-Wheeler transform over the encseq codes: the encoded
        char preceding each suffix verbatim (wildcards/separators kept),
        UNDEFBWTCHAR (= WILDCARD, 254) for the position-0 suffix
        (ref: sfx-run.c:173 bwttab2file; chardef.h:65 UNDEFBWTCHAR).
        Byte-identical to the compiled gt binary's .bwt on testdata."""
        codes = self.encseq.codes_view(self.readmode)
        n = codes.size
        prev = self.suftab.astype(np.int64) - 1
        vals = codes[np.clip(prev, 0, max(n - 1, 0))].astype(np.uint8)
        vals[prev < 0] = 254                   # UNDEFBWTCHAR == WILDCARD
        return vals


@dataclass
class Bcktab:
    """Per-code bucket table in the reference's exact on-disk semantics
    (ref: src/match/bcktab.c; byte-identical .bck vs the compiled gt
    binary on testdata).

    ``leftborder[c]`` = first suftab index of the bucket for code c
    (exclusive prefix sums over per-code counts — the state the reference
    file captures after PASS-B insertion has decremented the inclusive
    sums back to left borders); ``leftborder[numofallcodes]`` = total
    counted suffixes.  Counted suffixes are every suffix NOT starting at a
    special char; a suffix whose ell-window hits a special (or the
    sequence end) at offset j >= 1 counts at maxcode =
    (prefcode+1)*sigma^(ell-j) - 1 (ref: gt_bcktab_updatespecials,
    bcktab.c:876, filltable insertion).

    ``countspecialcodes[s]`` counts those special-window suffixes per
    specialcode s = GT_FROMCODE2SPECIALCODE(maxcode) (= maxcode >> 2 for
    DNA, bcktab.c:43); suffixes starting at specials and the sentinel are
    NOT included (gt_bcktab_addfinalspecials is dead code in the
    reference).

    ``distpfxidx`` concatenates, for prefixindex j = 1..ell-2, the
    per-j-prefix-code counts of special-window suffixes (sigma^j entries
    each; ref: gt_bcktab_distpfxidx_increment / setdistpfxidxptrs)."""

    prefixlength: int
    num_chars: int
    leftborder: np.ndarray         # int64[numofallcodes + 1]
    countspecialcodes: np.ndarray  # int64[sigma^(prefixlength-1)]
    distpfxidx: np.ndarray         # int64[sum_{j=1}^{ell-2} sigma^j]

    @property
    def numofallcodes(self) -> int:
        return self.num_chars ** self.prefixlength


def compute_bcktab(esa: EnhancedSuffixArray, prefixlength: int) -> Bcktab:
    """Bucket table over prefixlength-codes (see Bcktab docstring for the
    exact reference semantics this reproduces)."""
    enc = esa.encseq
    sigma = enc.alphabet.num_chars
    ell = prefixlength
    numofallcodes = sigma ** ell
    codes = enc.codes_view(esa.readmode)
    n = codes.size

    sym = np.where(is_special(codes), 0, codes).astype(np.int64)
    special = is_special(codes)
    # first special offset within [p, p+ell), clamped to ell; windows that
    # run off the sequence end count the sentinel as special
    first_special = np.full(n, ell, np.int64)
    pref = np.zeros(n, np.int64)  # running prefix code up to first special
    done = np.zeros(n, bool)
    for j in range(ell):
        in_range = np.arange(n) + j < n
        sp = np.where(in_range, np.concatenate([special[j:], np.ones(j, bool)]), True)
        hit = sp & ~done
        first_special[hit] = j
        done |= hit
        ext = np.where(in_range, np.concatenate([sym[j:], np.zeros(j, np.int64)]), 0)
        pref = np.where(done, pref, pref * sigma + ext)
    regular = first_special == ell

    counted = ~special                       # prefixindex >= 1 or regular
    j = first_special
    code = np.where(regular, pref,
                    (pref + 1) * sigma ** (ell - np.minimum(j, ell)) - 1)
    counts = np.bincount(code[counted], minlength=numofallcodes)
    leftborder = np.zeros(numofallcodes + 1, np.int64)
    leftborder[1:numofallcodes] = np.cumsum(counts)[:-1]
    leftborder[numofallcodes] = counts.sum()

    spec_mask = counted & ~regular
    cs = code[spec_mask]
    sc = cs >> 2 if sigma == 4 else (cs - (sigma - 1)) // sigma
    countspecialcodes = np.bincount(sc, minlength=sigma ** (ell - 1))

    blocks = [np.bincount(pref[counted & (j == jj)], minlength=sigma ** jj)
              for jj in range(1, ell - 1)]
    distpfxidx = np.concatenate(blocks) if blocks \
        else np.zeros(0, np.int64)
    return Bcktab(prefixlength, sigma, leftborder,
                  countspecialcodes.astype(np.int64),
                  distpfxidx.astype(np.int64))


def dist_mesh(n: int | None, device="cuda"):
    """The mesh of the sharded suffix sort: n shards (all attached cards
    for None; one, the single-device route, for 0), at most the attached
    cards, rounded down to a power of two (the CPU: n shards of it)."""
    from ..device import resolve_device
    from ..parallel.mesh import Mesh, make_mesh, pow2_floor
    dev = resolve_device(device)
    if n == 0:
        return Mesh([dev])
    if dev.type == "cpu":
        return make_mesh(pow2_floor(n or 1), dev)
    have = torch.cuda.device_count()
    if have <= 1:
        return Mesh([dev])
    return make_mesh(pow2_floor(min(n or have, have)), dev)


def build_esa(encseq: Encseq, readmode: int = FWD, with_lcp: bool = True,
              prefixlength: int | None = None, with_bck: bool = False,
              device="cuda", mesh=None) -> EnhancedSuffixArray:
    """suffixerator equivalent: encseq -> (suftab, lcptab[, bcktab]),
    with the suffix sort on `device`. On a mesh of more than one shard
    (by default dist_mesh(None, device): every attached card, a power of
    two) the sort is the sharded sample-sort engine and the LCP the
    host's Kasai (ref: the reference's threaded bucket fan-out,
    sfx-suffixer.c); the tables are the same."""
    keys = encseq.suffix_keys(readmode)
    if mesh is None:
        mesh = dist_mesh(None, device)
    if mesh.size > 1:
        from ..parallel.dist_doubling_sharded import sharded_suffix_array
        sa = sharded_suffix_array(keys, mesh)
        lcp = kasai_lcp_native(keys, sa) if with_lcp else None
        if with_lcp and lcp is None:
            raise RuntimeError("the native host engine is unavailable")
    else:
        sa, lcp = build_suffix_array(keys, with_lcp=with_lcp,
                                     device=mesh.devices[0])
        sa = sa.cpu().numpy()
        lcp = lcp.cpu().numpy() if with_lcp else None
    pl = prefixlength or recommended_prefixlength(
        encseq.alphabet.num_chars, encseq.total_length)
    esa = EnhancedSuffixArray(
        encseq=encseq, readmode=readmode, suftab=sa, lcptab=lcp,
        prefixlength=pl)
    if with_bck:
        esa.bcktab = compute_bcktab(esa, pl)
    return esa


def host_sa_lcp(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(suffix array, LCP) of suffix keys by the host C++ SA-IS and
    Kasai engines: a construction independent of build_esa's."""
    sa = sais_native(keys)
    if sa is None:
        raise RuntimeError("the native host engine is unavailable")
    return sa, kasai_lcp_native(keys, sa)


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

_WORD = np.dtype(np.uint64).newbyteorder("=")


def write_esa(esa: EnhancedSuffixArray, indexname: str,
              suf: bool = True, lcp: bool = True, bwt: bool = False,
              bck: bool = False, intsize: int = 64) -> None:
    dt = np.uint64 if intsize == 64 else np.uint32
    if suf:
        esa.suftab.astype(dt).tofile(indexname + ".suf")
    numoflargelcps = 0
    maxbranchdepth = 0
    avg = 0.0
    if lcp and esa.lcptab is not None:
        lcptab = esa.lcptab
        small = np.minimum(lcptab, LCP_OVERFLOW).astype(np.uint8)
        big_idx = np.nonzero(lcptab >= LCP_OVERFLOW)[0]
        numoflargelcps = int(big_idx.size)
        small[big_idx] = LCP_OVERFLOW
        small.tofile(indexname + ".lcp")
        llv = np.empty((numoflargelcps, 2), dt)
        llv[:, 0] = big_idx
        llv[:, 1] = lcptab[big_idx]
        llv.tofile(indexname + ".llv")
        if lcptab.size:
            maxbranchdepth = int(lcptab.max())
            # averagelcp: the reference's Outlcpinfo sums only lcp values
            # flushed for NONSPECIAL bucket slots (suffixes with a
            # special-free full prefixlength window); lcp values written
            # for special bucket ends / the trailing special area are not
            # accumulated (ref: sfx-lcpvalues.c:414 lcptabsum vs
            # lcp_bucketends:125, averagelcp division sfx-run.c:679)
            # windows are over the sorting readmode's view (verified vs
            # gt: -dir rev Atinsert averagelcp=2.15, not the fwd 1.00)
            codes = esa.encseq.codes_view(esa.readmode)
            n = codes.size
            pl = esa.prefixlength
            spc = np.concatenate(
                [[0], np.cumsum(is_special(codes).astype(np.int64))])
            sa = esa.suftab
            valid = sa + pl <= n
            cnt = np.ones(sa.size, np.int64)
            sav = sa[valid]
            cnt[valid] = spc[sav + pl] - spc[sav]
            nonspecial = valid & (cnt == 0)
            avg = float(lcptab[nonspecial].sum()) / esa.suftab.size
    if bwt:
        esa.bwt().tofile(indexname + ".bwt")
    if bck and esa.bcktab is not None:
        # reference .bck: mapspec sections (leftborder, countspecialcodes,
        # distpfxidx), each 8-byte padded; uint32 entries unless
        # totallength+1 overflows (ref: gt_bcktab_flush_to_file,
        # core/mapspec.c gt_mapspec_pad, gt_bcktab_useulong)
        b = esa.bcktab
        bdt = np.uint64 if esa.total_length + 1 > 0xFFFFFFFF else np.uint32
        with open(indexname + ".bck", "wb") as fp:
            for arr in (b.leftborder, b.countspecialcodes, b.distpfxidx):
                if arr.size == 0:
                    continue
                raw = arr.astype(bdt).tobytes()
                if len(raw) % 8:
                    raw += b"\0" * (8 - len(raw) % 8)
                fp.write(raw)
    _write_prj(esa, indexname, numoflargelcps, avg, maxbranchdepth, intsize)


def _write_prj(esa: EnhancedSuffixArray, indexname: str,
               numoflargelcps: int, averagelcp: float, maxbranchdepth: int,
               intsize: int) -> None:
    enc = esa.encseq
    codes = enc.codes
    sp = is_special(codes)
    n = codes.size
    # prefix/suffix special run lengths
    lpre = int(np.argmin(sp)) if not sp.all() else n
    lsuf = int(np.argmin(sp[::-1])) if not sp.all() else n
    wc = codes == 254
    wpre = int(np.argmin(wc)) if not wc.all() else n
    wsuf = int(np.argmin(wc[::-1])) if not wc.all() else n
    lines = [
        f"totallength={n}",
        f"specialcharacters={enc.special_ranges.total}",
        f"specialranges={enc.special_ranges.count}",
        f"realspecialranges={enc.special_ranges.count}",
        f"lengthofspecialprefix={lpre if sp.size and sp[0] else 0}",
        f"lengthofspecialsuffix={lsuf if sp.size and sp[-1] else 0}",
        f"wildcards={enc.wildcard_ranges.total}",
        f"wildcardranges={enc.wildcard_ranges.count}",
        f"realwildcardranges={enc.wildcard_ranges.count}",
        f"lengthofwildcardprefix={wpre if wc.size and wc[0] else 0}",
        f"lengthofwildcardsuffix={wsuf if wc.size and wc[-1] else 0}",
        f"numofsequences={enc.num_sequences}",
        f"numofdbsequences={enc.num_sequences}",
        "numofquerysequences=0",
        f"numberofallsortedsuffixes={esa.suftab.size}",
        f"longest={esa.longest}",
        f"prefixlength={esa.prefixlength}",
        f"largelcpvalues={numoflargelcps}",
        f"averagelcp={averagelcp:.2f}",
        f"maxbranchdepth={maxbranchdepth}",
        f"integersize={intsize}",
        f"littleendian={'1' if sys.byteorder == 'little' else '0'}",
        f"readmode={esa.readmode}",
        f"mirrored={'1' if enc.mirrored else '0'}",
    ]
    Path(indexname + ".prj").write_text("\n".join(lines) + "\n")


def read_prj(indexname: str) -> dict:
    out = {}
    for line in Path(indexname + ".prj").read_text().splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            out[k] = v
    return out


def load_esa(indexname: str, encseq: Encseq | None = None,
             need_lcp: bool | str = True,
             signed_suftab: bool | str = True) -> EnhancedSuffixArray:
    """An index read from its files (ref: gt_mapsuffixarray,
    src/match/esa-map.c).

    need_lcp="small" keeps only the capped .lcp bytes (esa.lcp_small);
    signed_suftab=False skips the uint64->int64 copy for consumers that
    only gather with the table; "i32" converts the tables straight to
    the int32 the native walkers take."""
    prj = read_prj(indexname)
    intsize = int(prj.get("integersize", 64))
    dt = np.uint64 if intsize == 64 else np.uint32
    n = int(prj["totallength"])
    if encseq is None:
        encseq = Encseq.load(indexname)
    suftab = np.fromfile(indexname + ".suf", dtype=dt)
    i32 = signed_suftab == "i32" and n + 1 < 2 ** 31
    if i32:
        suftab = suftab.astype(np.int32)
    elif signed_suftab:
        suftab = suftab.astype(np.int64)
    if suftab.size != n + 1:
        raise ValueError(f"{indexname}.suf holds {suftab.size} entries, "
                         f"the .prj says {n + 1}")
    lcptab = small = None
    if need_lcp and Path(indexname + ".lcp").exists():
        small = np.fromfile(indexname + ".lcp", dtype=np.uint8)
        if need_lcp != "small":
            lcptab, small = small.astype(np.int32 if i32 else np.int64), None
            llv_path = Path(indexname + ".llv")
            if llv_path.exists() and llv_path.stat().st_size:
                llv = np.fromfile(llv_path, dtype=dt).reshape(-1, 2)
                lcptab[llv[:, 0].astype(np.int64)] = \
                    np.minimum(llv[:, 1], 2 ** 31 - 1) if i32 else llv[:, 1]
    return EnhancedSuffixArray(
        encseq=encseq, readmode=int(prj.get("readmode", FWD)),
        suftab=suftab, lcptab=lcptab,
        prefixlength=int(prj.get("prefixlength", 0)), lcp_small=small)


def merge_esas(encseqs: list[Encseq], with_lcp: bool = True,
               device="cuda") -> EnhancedSuffixArray:
    """Merge several indexed sequence sets into one ESA
    (ref: gt dev mergeesa, src/match/esa-merge.c / emimergeesa.h).

    The reference streams and merges presorted suffix readers; here, as
    in the reference package, the combined index is rebuilt: the encseqs
    are concatenated (a separator between two sets) and ``build_esa``
    sorts the result on `device`. The result is exactly the ESA of the
    concatenated sequence sets."""
    from ..core.chardef import SEPARATOR
    parts = []
    ssp = []
    descs = []
    off = 0
    for i, e in enumerate(encseqs):
        if i > 0:
            ssp.append(off)
            off += 1
        parts.append(e.codes)
        # inner separators shift by current offset
        ssp.extend((e.ssp + off).tolist())
        off += e.codes.size
        descs.extend(e.descs)
    codes = np.empty(off, np.uint8)
    pos = 0
    for i, pcodes in enumerate(parts):
        if i > 0:
            codes[pos] = SEPARATOR
            pos += 1
        codes[pos:pos + pcodes.size] = pcodes
        pos += pcodes.size
    merged = Encseq(codes, np.asarray(sorted(ssp), np.int64), descs,
                    encseqs[0].alphabet)
    return build_esa(merged, with_lcp=with_lcp, device=device)
