"""Loader for the native host-side library (``native/gtnative.cpp``).

The port's copy of the parts of ``genometools_tpu/core/native.py`` that
the port calls: the ctypes loader and the host engines of the
suffixerator, seed_extend and repfind paths (SA-IS and Kasai, FASTA
intake, the .esq two-bit decoder, k-mer lists, the seed-pair join, the
greedy and xdrop batches, the fused seed_extend engine, the maximal-pairs
walks and the match-line writer), of tallymer (the ESA walk, the
ESA-free counter, the .mer lookup, the search-line writer) and of
readjoiner (the FASTA read cleaner, the SPM join, the unitig walk).
The C++ sources are the repository's shared ``native/gtnative.cpp`` and
the port's own ``csrc/diagband.cpp`` (seed_extend's diagonal-band
filter); they are compiled on demand with g++ -O3 into one library in
``genometools_torch/_build/`` and loaded via ctypes. Every function
returns None when the library cannot be built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SRCS = (_REPO / "native" / "gtnative.cpp",
         Path(__file__).resolve().parents[1] / "csrc" / "diagband.cpp")
_CACHE = Path(__file__).resolve().parents[1] / "_build"

_lib = None
_tried = False
_lock = threading.Lock()          # one build and load, whichever thread

def _compile() -> Path | None:
    if not all(src.exists() for src in _SRCS):
        return None
    h = hashlib.sha256()
    for src in _SRCS:
        h.update(src.read_bytes())
    tag = h.hexdigest()[:16]
    out = _CACHE / f"gtnative-{tag}.so"
    if out.exists():
        return out
    _CACHE.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=str(_CACHE)) as td:
        tmp = Path(td) / "gtnative.so"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-pthread", "-std=c++17", *map(str, _SRCS), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        except (subprocess.SubprocessError, FileNotFoundError):
            return None
        os.replace(tmp, out)
    return out


def get_lib():
    """Return the loaded ctypes library or None."""
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if not _tried:
            _load()
    return _lib


def _load() -> None:
    global _lib, _tried
    try:
        so = _compile()
        if so is not None:
            _lib = _bind(ctypes.CDLL(str(so)))
    finally:
        _tried = True


def _bind(lib):
    """lib with the argument types of its always-bound functions."""
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    pp = ctypes.POINTER(i32p)

    lib.gt_free.argtypes = [ctypes.c_void_p]
    lib.gt_kasai_lcp.argtypes = [i32p, i32p, ctypes.c_int64, i32p]
    lib.gt_xdrop_batch.argtypes = [
        u8p, i64p, u8p, i64p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.gt_greedy_batch.argtypes = [
        u8p, i64p, u8p, i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, i32p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, i64p]
    lib.gt_sais.argtypes = [i32p, ctypes.c_int64, i32p]
    lib.gt_maxpairs.restype = ctypes.c_int64
    lib.gt_maxpairs.argtypes = [
        i32p, i32p, u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint8,
        pp, pp, pp]
    lib.gt_maxpairs_stream_new.restype = ctypes.c_void_p
    lib.gt_maxpairs_stream_new.argtypes = [ctypes.c_int32, ctypes.c_uint8]
    lib.gt_maxpairs_stream_feed.argtypes = [
        ctypes.c_void_p, i32p, i32p, u8p, ctypes.c_int64]
    lib.gt_maxpairs_stream_finish.restype = ctypes.c_int64
    lib.gt_maxpairs_stream_finish.argtypes = [ctypes.c_void_p, pp, pp, pp]
    lib.gt_write_match_lines.restype = ctypes.c_int
    lib.gt_write_match_lines.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_char, ctypes.c_char_p, ctypes.c_int]
    lib.gt_seed_pair_join.restype = ctypes.c_int64
    lib.gt_seed_pair_join.argtypes = [
        i64p, i32p, i32p, ctypes.c_int64,
        i64p, i32p, i32p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        pp, pp, pp, pp]
    try:
        lib.gt_seed_pair_join2.restype = ctypes.c_int64
        lib.gt_seed_pair_join2.argtypes = [
            i64p, i32p, i32p, ctypes.c_int64,
            i64p, i32p, i32p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, u64p,
            ctypes.POINTER(u64p), pp, pp, pp, pp]
    except AttributeError:
        pass
    for fn, ip in ((lib.gt_diagband_select_i32, i32p),
                   (lib.gt_diagband_select_i64, i64p)):
        fn.restype = ctypes.c_int64
        fn.argtypes = [ip, ip, ip, ip, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_int, i64p, i64p, i64p, i64p, i64p]
    return lib


def _pack_seqs(seqs):
    """Concatenate uint8 sequences; return (blob, offsets[2n] = (off, len))."""
    offs = np.zeros(2 * len(seqs), np.int64)
    pos = 0
    parts = []
    for i, s in enumerate(seqs):
        s = np.ascontiguousarray(s, np.uint8)
        offs[2 * i] = pos
        offs[2 * i + 1] = s.size
        parts.append(s)
        pos += s.size
    blob = np.concatenate(parts) if parts else np.zeros(1, np.uint8)
    return blob, offs


def xdrop_batch_native(us, vs, belowscore: int):
    """Batched xdrop over pairs (us[i], vs[i]). Returns int64[n,3]
    (ivalue, jvalue, score) or None if no native lib."""
    lib = get_lib()
    if lib is None:
        return None
    ublob, uoff = _pack_seqs(us)
    vblob, voff = _pack_seqs(vs)
    n = len(us)
    out = np.zeros(3 * n, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.gt_xdrop_batch(
        ublob.ctypes.data_as(u8), uoff.ctypes.data_as(i64p),
        vblob.ctypes.data_as(u8), voff.ctypes.data_as(i64p),
        n, belowscore, out.ctypes.data_as(i64p))
    return out.reshape(n, 3)


def greedy_batch_native(us, vs, *, max_history, perc_mat_history,
                        maxalignedlendifference, seedlengths, pol,
                        trim=True):
    """Batched greedy front-prune. Returns int64[n,6]
    (alignedlen, row, distance, max_mismatches, died, touched) —
    touched=1 means a live front cell hit the u/v window end, so a
    clipped-window caller must re-run that lane — or None."""
    lib = get_lib()
    if lib is None:
        return None
    ublob, uoff = _pack_seqs(us)
    vblob, voff = _pack_seqs(vs)
    n = len(us)
    sl = np.ascontiguousarray(seedlengths, np.int64)
    out = np.zeros(6 * n, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    dfm = np.ascontiguousarray(pol.diff_from_max, np.int32)
    ssum = np.ascontiguousarray(pol.score_sum, np.int32)
    lib.gt_greedy_batch(
        ublob.ctypes.data_as(u8), uoff.ctypes.data_as(i64p),
        vblob.ctypes.data_as(u8), voff.ctypes.data_as(i64p),
        n, max_history, perc_mat_history, maxalignedlendifference,
        sl.ctypes.data_as(i64p), _i32ptr(dfm), _i32ptr(ssum),
        pol.cut_depth, pol.mask, 1 if trim else 0,
        out.ctypes.data_as(i64p))
    return out.reshape(n, 6)


def sais_native(keys) -> np.ndarray | None:
    """SA-IS linear-time suffix array over int32 suffix keys — the
    independent second construction path (capability equivalent of
    `gt dev sain`, ref: src/match/sfx-sain.c:1577). Returns int32[n]
    or None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, np.int32)
    out = np.empty(keys.size, np.int32)
    lib.gt_sais(_i32ptr(keys), keys.size, _i32ptr(out))
    return out


def _as_i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _take_array(lib, ptr, count: int) -> np.ndarray:
    """Copy a malloc'd int32 array into numpy and free the original."""
    if count == 0:
        lib.gt_free(ptr)
        return np.zeros(0, np.int32)
    out = np.ctypeslib.as_array(ptr, shape=(count,)).copy()
    lib.gt_free(ptr)
    return out


def kasai_lcp_native(keys: np.ndarray, sa: np.ndarray) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    keys = _as_i32(keys)
    sa = _as_i32(sa)
    lcp = np.zeros(sa.size, np.int32)
    lib.gt_kasai_lcp(_i32ptr(keys), _i32ptr(sa), sa.size, _i32ptr(lcp))
    return lcp


def maxpairs_native(sa: np.ndarray, lcp: np.ndarray, cls: np.ndarray,
                    searchlength: int, sigma: int):
    """The bottom-up maximal-pairs walk (gt_maxpairs) over (sa, lcp) and
    the left-context classes: (pos1, pos2, length) int32, or None."""
    lib = get_lib()
    if lib is None:
        return None
    sa = _as_i32(sa)
    lcp = _as_i32(lcp)
    cls = np.ascontiguousarray(cls, dtype=np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    p1, p2, pl = i32p(), i32p(), i32p()
    cnt = lib.gt_maxpairs(
        _i32ptr(sa), _i32ptr(lcp),
        cls.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.size, searchlength, sigma,
        ctypes.byref(p1), ctypes.byref(p2), ctypes.byref(pl))
    return (_take_array(lib, p1, cnt), _take_array(lib, p2, cnt),
            _take_array(lib, pl, cnt))


def maxpairs_esa_native(codes, suf_u64, lcp_small, llv_u64,
                        searchlength: int, sigma: int):
    """Maxpairs off memmapped on-disk ESA tables (gt_maxpairs_esa):
    u64 suftab + capped lcp bytes + llv exceptions, context classes
    derived inline. Returns (pos1, pos2, length) int32 or None."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        fn = lib.gt_maxpairs_esa
    except AttributeError:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    pp = ctypes.POINTER(i32p)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int64
        fn.argtypes = [u8p, ctypes.c_int64, u64p, u8p, u64p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                       ctypes.c_uint8, pp, pp, pp]
    codes = np.ascontiguousarray(codes, np.uint8)
    op1, op2, ol = i32p(), i32p(), i32p()
    cnt = fn(codes.ctypes.data_as(u8p), codes.size,
             suf_u64.ctypes.data_as(u64p), lcp_small.ctypes.data_as(u8p),
             llv_u64.ctypes.data_as(u64p), llv_u64.size // 2,
             suf_u64.size, int(searchlength), int(sigma),
             ctypes.byref(op1), ctypes.byref(op2), ctypes.byref(ol))
    if cnt < 0:
        return None
    return (_take_array(lib, op1, cnt), _take_array(lib, op2, cnt),
            _take_array(lib, ol, cnt))


class MaxpairsStream:
    """Streaming maximal-pairs walker (the Sequentialsuffixarrayreader
    consumer model, ref: src/match/esa-seqread.h:27): feed (sa, lcp,
    cls) chunks in rank order, finish() returns the pair arrays. Memory
    is bounded by the positions inside open intervals of depth >=
    searchlength. Raises when the native library cannot be built."""

    def __init__(self, searchlength: int, sigma: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("the native maximal-pairs walk is "
                               "unavailable")
        self._lib = lib
        self._h = lib.gt_maxpairs_stream_new(searchlength, sigma)

    def feed(self, sa, lcp, cls):
        sa = _as_i32(sa)
        lcp = _as_i32(lcp)
        cls = np.ascontiguousarray(cls, np.uint8)
        self._lib.gt_maxpairs_stream_feed(
            self._h, _i32ptr(sa), _i32ptr(lcp),
            cls.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), sa.size)

    def finish(self):
        i32p = ctypes.POINTER(ctypes.c_int32)
        p1, p2, pl = i32p(), i32p(), i32p()
        cnt = self._lib.gt_maxpairs_stream_finish(
            self._h, ctypes.byref(p1), ctypes.byref(p2), ctypes.byref(pl))
        self._h = None
        return (_take_array(self._lib, p1, cnt),
                _take_array(self._lib, p2, cnt),
                _take_array(self._lib, pl, cnt))


def write_match_lines_native(rows: np.ndarray, direction: str,
                             path: str, append: bool) -> bool:
    """Bulk "len s1 r1 D len s2 r2" line emission in C; False without
    the lib (the caller formats in Python)."""
    lib = get_lib()
    if lib is None:
        return False
    rows = np.ascontiguousarray(rows, np.int64)
    rc = lib.gt_write_match_lines(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rows.shape[0], direction.encode()[0:1], path.encode(),
        1 if append else 0)
    return rc == 0


# sorted a-list pack reuse across join calls (the two strands of one
# seed_extend run share alist): keyed by object identity with a
# liveness check — id() alone can be recycled after GC
_JOIN_PACK_CACHE: dict = {}


def seed_pair_join_native(alist, blist, selfcomp: bool,
                          maxfreq, inseqseeds: bool, mindist: int,
                          maxdist):
    """Seed-pair join (gt_seed_pair_join, the gt_diagbandseed_merge
    capability — ref: src/match/diagbandseed.c:2654): returns
    (aseq, bseq, bpos, apos) int64 arrays sorted by
    (aseq, bseq, bpos, apos), or None when the native lib is absent or
    the inputs exceed the packed 64-bit budget (caller falls back to
    the numpy join)."""
    lib = get_lib()
    if lib is None:
        return None
    acode, aseq, apos = alist
    bcode, bseq, bpos = blist
    same = blist is alist or acode is bcode
    if acode.size == 0 or bcode.size == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    # seq/pos must fit int32 planes (wide inputs: numpy fallback)
    if max(int(aseq.max()), int(bseq.max()), int(apos.max()),
           int(bpos.max())) >= 2 ** 31:
        return None
    ac = np.ascontiguousarray(acode, np.int64)
    as_ = np.ascontiguousarray(aseq, np.int32)
    ap = np.ascontiguousarray(apos, np.int32)
    if same:
        bc, bs, bp = ac, as_, ap
    else:
        bc = np.ascontiguousarray(bcode, np.int64)
        bs = np.ascontiguousarray(bseq, np.int32)
        bp = np.ascontiguousarray(bpos, np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    oas, obs, obp, oap = i32p(), i32p(), i32p(), i32p()
    # sorted-pack reuse: fixed (cb, iab=32) budget so the pack is
    # byte-compatible across the strands sharing this a list
    use_cache = hasattr(lib, "gt_seed_pair_join2") and \
        ac.size >= (1 << 20)
    force_cb = int(ac.max()).bit_length() if use_cache else 0
    if force_cb == 0 or force_cb + 32 > 64:
        use_cache = False
    cached = None
    if use_cache:
        ent = _JOIN_PACK_CACHE.get(id(acode))
        if ent is not None and ent[0]() is acode and \
                ent[1] == force_cb:
            cached = ent[2]
    out_pack = u64p()

    def call(cb, iab, pack_in, want_pack):
        return lib.gt_seed_pair_join2(
            ac.ctypes.data_as(i64p), as_.ctypes.data_as(i32p),
            ap.ctypes.data_as(i32p), ac.size,
            bc.ctypes.data_as(i64p), bs.ctypes.data_as(i32p),
            bp.ctypes.data_as(i32p), bc.size,
            int(same), int(selfcomp), int(inseqseeds),
            int(maxfreq) if maxfreq is not None else 0,
            int(mindist), int(maxdist) if maxdist is not None else -1,
            os.cpu_count() or 1, cb, iab,
            pack_in.ctypes.data_as(u64p) if pack_in is not None
            else None,
            ctypes.byref(out_pack) if want_pack else None,
            ctypes.byref(oas), ctypes.byref(obs), ctypes.byref(obp),
            ctypes.byref(oap))

    if use_cache:
        want = cached is None
        cnt = call(force_cb, 32, cached, want)
        if cnt >= 0 and want:
            import weakref
            pk = np.ctypeslib.as_array(out_pack,
                                       shape=(int(ac.size),)).copy()
            lib.gt_free(out_pack)
            _JOIN_PACK_CACHE.clear()
            _JOIN_PACK_CACHE[id(acode)] = (weakref.ref(acode),
                                           force_cb, pk)
        if cnt == -2:       # budget mismatch: plain path
            cnt = call(0, 0, None, False)
    else:
        cnt = call(0, 0, None, False) if hasattr(
            lib, "gt_seed_pair_join2") else lib.gt_seed_pair_join(
            ac.ctypes.data_as(i64p), as_.ctypes.data_as(i32p),
            ap.ctypes.data_as(i32p), ac.size,
            bc.ctypes.data_as(i64p), bs.ctypes.data_as(i32p),
            bp.ctypes.data_as(i32p), bc.size,
            int(same), int(selfcomp), int(inseqseeds),
            int(maxfreq) if maxfreq is not None else 0,
            int(mindist), int(maxdist) if maxdist is not None else -1,
            os.cpu_count() or 1,
            ctypes.byref(oas), ctypes.byref(obs), ctypes.byref(obp),
            ctypes.byref(oap))
    if cnt < 0:
        return None
    return tuple(_take_array(lib, p, cnt) for p in (oas, obs, obp, oap))


def diagband_select_native(pa_seq, pb_seq, pb_pos, pa_pos, *, k: int,
                           amaxlen: int, logw: int, mincov: int,
                           use_filter: bool):
    """seed_extend's diagonal-band filter (``csrc/diagband.cpp``) over
    joined seed pairs sorted by (aseq, bseq, bpos, apos): the native
    join's int32 planes as they are, any other input as int64. Returns
    (idx, sseg, kstart, g_end) int64 arrays: the kept pair indices in
    ascending order, each kept seed's ordinal among the segments that
    keep one, those segments' first pair indices, and each one's end in
    idx. use_filter False keeps every seed."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native diagonal-band filter is unavailable")
    planes = (pa_seq, pb_seq, pb_pos, pa_pos)
    if len({a.shape for a in planes}) != 1 or pa_seq.ndim != 1:
        raise ValueError("the seed pairs' planes must be 1-d and of one "
                         "length")
    if all(a.dtype == np.int32 for a in planes):
        fn, ip = lib.gt_diagband_select_i32, ctypes.POINTER(ctypes.c_int32)
        planes = [np.ascontiguousarray(a) for a in planes]
    else:
        fn, ip = lib.gt_diagband_select_i64, ctypes.POINTER(ctypes.c_int64)
        planes = [np.ascontiguousarray(a, np.int64) for a in planes]
    n = planes[0].size
    idx, sseg, kstart, g_end = (np.empty(n, np.int64) for _ in range(4))
    i64p = ctypes.POINTER(ctypes.c_int64)
    nkept = ctypes.c_int64(0)
    nsel = fn(*(a.ctypes.data_as(ip) for a in planes), n, int(k),
              int(amaxlen), int(logw), int(mincov), int(use_filter),
              *(a.ctypes.data_as(i64p) for a in (idx, sseg, kstart, g_end)),
              ctypes.byref(nkept))
    if nsel < 0:
        raise ValueError("a seed pair lies below the lowest diagonal band")
    return idx[:nsel], sseg[:nsel], kstart[:nkept.value], g_end[:nkept.value]


def seedext_greedy_run_native(aflat, bflat, a_start, a_len, b_start, b_len,
                              pa_seq, pb_seq, pb_pos, pa_pos, *, k, amaxlen,
                              logw, mincov, use_filter, selfcomp, is_p,
                              max_combine, history, pmh, mad, pol,
                              errperc, leastlen2, engine=0,
                              belowscore=0):
    """Fused seed_extend greedy engine (gt_seedext_greedy_run): the whole
    per-strand diagband-filter + sequential skip/extend/accept walk over
    the joined pair lists, flanks extended in place over the flat code
    arrays (capability of gt_diagbandseed_process_seeds + gt_extend_sesp,
    ref: src/match/diagbandseed.c:4136).  Returns int64[n, 12] match
    records in emission order, or None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        fn = lib.gt_seedext_greedy_run
    except AttributeError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int64
        fn.argtypes = [u8p, u8p, i64p, i64p, i64p, i64p,
                       i32p, i32p, i32p, i32p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       i32p, i32p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int64, ctypes.POINTER(i64p)]
    aflat = np.ascontiguousarray(aflat, np.uint8)
    bflat = np.ascontiguousarray(bflat, np.uint8)
    a_start = np.ascontiguousarray(a_start, np.int64)
    a_len = np.ascontiguousarray(a_len, np.int64)
    b_start = np.ascontiguousarray(b_start, np.int64)
    b_len = np.ascontiguousarray(b_len, np.int64)
    pa_seq = _as_i32(pa_seq)
    pb_seq = _as_i32(pb_seq)
    pb_pos = _as_i32(pb_pos)
    pa_pos = _as_i32(pa_pos)
    dfm = np.ascontiguousarray(pol.diff_from_max, np.int32)
    ssum = np.ascontiguousarray(pol.score_sum, np.int32)
    out = i64p()
    cnt = fn(aflat.ctypes.data_as(u8p), bflat.ctypes.data_as(u8p),
             a_start.ctypes.data_as(i64p), a_len.ctypes.data_as(i64p),
             b_start.ctypes.data_as(i64p), b_len.ctypes.data_as(i64p),
             _i32ptr(pa_seq), _i32ptr(pb_seq), _i32ptr(pb_pos),
             _i32ptr(pa_pos), pa_seq.size, int(k), int(amaxlen),
             int(logw), int(mincov), int(use_filter), int(selfcomp),
             int(is_p), int(max_combine), int(history), int(pmh),
             int(mad), _i32ptr(dfm), _i32ptr(ssum), pol.cut_depth,
             pol.mask, int(errperc), int(leastlen2), int(engine),
             int(belowscore), ctypes.byref(out))
    if cnt < 0:
        lib.gt_free(out)
        return None
    if cnt == 0:
        lib.gt_free(out)
        return np.zeros((0, 12), np.int64)
    recs = np.ctypeslib.as_array(out, shape=(int(cnt) * 12,)).copy()
    lib.gt_free(out)
    return recs.reshape(int(cnt), 12)


def kmer_list_native(flat, seq_start, seq_len, k: int):
    """All valid k-windows over per-sequence spans of a flat code array
    (gt_kmer_list; capability of gt_diagbandseed_get_kmers, ref:
    src/match/diagbandseed.c:1189). Returns (code int64, seq int32,
    endpos int32) or None without the lib / k > 31."""
    lib = get_lib()
    if lib is None or k > 31:
        return None
    try:
        fn = lib.gt_kmer_list
    except AttributeError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int64
        fn.argtypes = [u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                       i64p, ctypes.POINTER(ctypes.c_int32),
                       ctypes.POINTER(ctypes.c_int32)]
    flat = np.ascontiguousarray(flat, np.uint8)
    seq_start = np.ascontiguousarray(seq_start, np.int64)
    seq_len = np.ascontiguousarray(seq_len, np.int64)
    cap = int(np.maximum(seq_len - k + 1, 0).sum())
    if cap == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros(0, np.int32))
    code = np.empty(cap, np.int64)
    seq = np.empty(cap, np.int32)
    pos = np.empty(cap, np.int32)
    n = fn(flat.ctypes.data_as(u8p), seq_start.ctypes.data_as(i64p),
           seq_len.ctypes.data_as(i64p), seq_start.size, int(k),
           code.ctypes.data_as(i64p), _i32ptr(seq), _i32ptr(pos))
    return code[:n], seq[:n], pos[:n]


def twobit_decode_native(words: np.ndarray, total: int):
    """Decode the .esq 2-bit plane (gt_twobit_decode) — threaded LUT
    stores. Returns uint8[total] or None."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        fn = lib.gt_twobit_decode
    except AttributeError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if fn.argtypes is None:
        fn.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, u8p]
    wb = np.ascontiguousarray(words).view(np.uint8)
    nwords = wb.size // 8
    out = np.empty(nwords * 32, np.uint8)
    fn(wb.ctypes.data_as(u8p), nwords, total, out.ctypes.data_as(u8p))
    return out[:total]


def fasta_encseq_native(data: bytes, lut: np.ndarray):
    """One-pass FASTA -> encseq codes (gt_fasta_encseq): payload bytes
    mapped through the given 256-entry alphabet LUT, SEPARATOR between
    sequences, headers as byte spans. Returns (codes u8, lens i64,
    hdr_start i64, hdr_end i64, seen u8[256]) or None."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        fn = lib.gt_fasta_encseq
    except AttributeError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int64
        fn.argtypes = [u8p, ctypes.c_int64, u8p, u8p, i64p, i64p,
                       i64p, u8p, i64p]
    buf = np.frombuffer(data, np.uint8)
    lut = np.ascontiguousarray(lut, np.uint8)
    codes = np.empty(buf.size + 1, np.uint8)
    cap = buf.size // 2 + 2
    lens = np.empty(cap, np.int64)
    hs = np.empty(cap, np.int64)
    he = np.empty(cap, np.int64)
    seen = np.zeros(256, np.uint8)
    cl = np.zeros(1, np.int64)
    ns = fn(buf.ctypes.data_as(u8p), buf.size,
            lut.ctypes.data_as(u8p), codes.ctypes.data_as(u8p),
            lens.ctypes.data_as(i64p), hs.ctypes.data_as(i64p),
            he.ctypes.data_as(i64p), seen.ctypes.data_as(u8p),
            cl.ctypes.data_as(i64p))
    return (codes[:int(cl[0])], lens[:ns], hs[:ns], he[:ns], seen)


def tallymer_mkindex_native(codes: np.ndarray, suftab: np.ndarray,
                            lcp_small: np.ndarray, k: int, minocc: int,
                            maxocc: int | None):
    """(packed_mers uint8[nmers, merbytes], counts uint32[nmers],
    counts_capped uint8[nmers]) or None without the lib. Single linear
    ESA pass in C++, the host engine for `tallymer mkindex`
    (ref: src/match/tyr-mkindex.c:514)."""
    lib = get_lib()
    if lib is None or k > 255:
        return None
    u8 = ctypes.POINTER(ctypes.c_uint8)
    fn = lib.gt_tallymer_mkindex
    if fn.argtypes is None:
        fn.argtypes = [
            u8, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64), u8,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            u8, ctypes.POINTER(ctypes.c_uint32), u8,
            ctypes.POINTER(ctypes.c_int64)]
    codes = np.ascontiguousarray(codes, np.uint8)
    suftab = np.ascontiguousarray(suftab, np.uint64)
    lcp_small = np.ascontiguousarray(lcp_small, np.uint8)
    n1 = suftab.size
    merbytes = (k + 3) // 4
    out_mers = np.empty((n1, merbytes), np.uint8)
    out_counts = np.empty(n1, np.uint32)
    out_small = np.empty(n1, np.uint8)
    nm = np.zeros(1, np.int64)
    fn(codes.ctypes.data_as(u8), codes.size,
       suftab.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
       lcp_small.ctypes.data_as(u8), n1, k, minocc,
       -1 if maxocc is None else maxocc,
       out_mers.ctypes.data_as(u8),
       out_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
       out_small.ctypes.data_as(u8),
       nm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    n = int(nm[0])
    return out_mers[:n], out_counts[:n], out_small[:n]


def spm_find_native(blob, starts, lens, k: int, minlen: int,
                    strand_canon: bool, lanes: int | None = None):
    """Readjoiner SPM join (gt_spm_find; capability of firstcodes +
    gt_spmsk, ref: src/match/firstcodes.c + esa-spmsk.c) over `lanes`
    threads (default: one per CPU). Returns (aidx, bidx, L) int64 arrays
    in ascending-position emission order, or None without the lib /
    k > 31."""
    lib = get_lib()
    if lib is None or k > 31 or k <= 0:
        return None
    try:
        lib.gt_spm_find
    except AttributeError:
        return None
    blob = np.ascontiguousarray(blob, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if lib.gt_spm_find.argtypes is None:
        lib.gt_spm_find.restype = ctypes.c_int64
        lib.gt_spm_find.argtypes = [
            u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(i64p), ctypes.POINTER(i64p),
            ctypes.POINTER(i64p)]
    oa, ob, ol = i64p(), i64p(), i64p()
    nlanes = lanes or os.cpu_count() or 1
    cnt = lib.gt_spm_find(
        blob.ctypes.data_as(u8p), starts.ctypes.data_as(i64p),
        lens.ctypes.data_as(i64p), starts.size, k, minlen,
        int(strand_canon), nlanes,
        ctypes.byref(oa), ctypes.byref(ob), ctypes.byref(ol))
    if cnt < 0:
        return None

    def take64(ptr, n):
        if n == 0:
            lib.gt_free(ptr)
            return np.zeros(0, np.int64)
        out = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
        lib.gt_free(ptr)
        return out
    return take64(oa, cnt), take64(ob, cnt), take64(ol, cnt)


def tallymer_count_native(flat, seq_start, seq_len, k: int, minocc: int,
                          maxocc):
    """ESA-free tallymer counting (gt_tallymer_count): radix over the
    window codes of the per-sequence spans; byte-identical mer/count
    planes to the ESA walk. Returns (packed, counts u32, small u8) or
    None."""
    lib = get_lib()
    if lib is None or k > 31:
        return None
    try:
        fn = lib.gt_tallymer_count
    except AttributeError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int64
        fn.argtypes = [u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       u8p, u32p, u8p]
    flat = np.ascontiguousarray(flat, np.uint8)
    seq_start = np.ascontiguousarray(seq_start, np.int64)
    seq_len = np.ascontiguousarray(seq_len, np.int64)
    cap = int(np.maximum(seq_len - k + 1, 0).sum())
    merbytes = (k + 3) // 4
    if cap == 0:
        return (np.zeros((0, merbytes), np.uint8), np.zeros(0, np.uint32),
                np.zeros(0, np.uint8))
    mers = np.empty((cap, merbytes), np.uint8)
    counts = np.empty(cap, np.uint32)
    small = np.empty(cap, np.uint8)
    nm = fn(flat.ctypes.data_as(u8p), seq_start.ctypes.data_as(i64p),
            seq_len.ctypes.data_as(i64p), seq_start.size, int(k),
            int(minocc), -1 if maxocc is None else int(maxocc),
            os.cpu_count() or 1, mers.ctypes.data_as(u8p),
            counts.ctypes.data_as(u32p), small.ctypes.data_as(u8p))
    if nm < 0:
        return None
    return mers[:nm], counts[:nm], small[:nm]


def tyr_write_lines_native(qs, qp, ct, st, path: str, with_seqnum: bool,
                           append: bool) -> bool:
    """Bulk tallymer-search line emission (gt_tyr_write_lines)."""
    lib = get_lib()
    if lib is None:
        return False
    try:
        fn = lib.gt_tyr_write_lines
    except AttributeError:
        return False
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [i64p, i64p, i64p, u8p, ctypes.c_int64,
                       ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    qs = np.ascontiguousarray(qs, np.int64)
    qp = np.ascontiguousarray(qp, np.int64)
    ct = np.ascontiguousarray(ct, np.int64)
    st = np.ascontiguousarray(st, np.uint8)
    rc = fn(qs.ctypes.data_as(i64p), qp.ctypes.data_as(i64p),
            ct.ctypes.data_as(i64p), st.ctypes.data_as(u8p), ct.size,
            path.encode(), 1 if with_seqnum else 0, 1 if append else 0)
    return rc == 0


def fasta_clean_reads_native(data: bytes):
    """FASTA bytes -> (blob u8, lens i64) of 2-bit-clean reads
    (gt_fasta_clean_reads; reads with non-ACGT symbols dropped whole).
    None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        fn = lib.gt_fasta_clean_reads
    except AttributeError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int64
        fn.argtypes = [u8p, ctypes.c_int64, u8p, i64p, i64p]
    buf = np.frombuffer(data, np.uint8)
    blob = np.empty(buf.size, np.uint8)
    lens = np.empty(buf.size // 2 + 2, np.int64)
    bl = np.zeros(1, np.int64)
    n = fn(buf.ctypes.data_as(u8p), buf.size, blob.ctypes.data_as(u8p),
           lens.ctypes.data_as(i64p), bl.ctypes.data_as(i64p))
    return blob[:int(bl[0])].copy(), lens[:n].copy()


def strgraph_spell_native(sb, sl, runs, indeg, nverts2, blob, rcblob,
                          starts, lens, min_depth, min_length):
    """Unitig spelling walk (gt_strgraph_spell). Returns
    (contig blob u8, lens, depths, start vertex, end vertex) or None."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        fn = lib.gt_strgraph_spell
    except AttributeError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int64
        fn.argtypes = [i64p, i64p, i64p, i64p, ctypes.c_int64, u8p,
                       u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, u8p, i64p, i64p, i64p, i64p,
                       i64p]
    sb = np.ascontiguousarray(sb, np.int64)
    sl = np.ascontiguousarray(sl, np.int64)
    runs = np.ascontiguousarray(runs, np.int64)
    indeg = np.ascontiguousarray(indeg, np.int64)
    blob = np.ascontiguousarray(blob, np.uint8)
    rcblob = np.ascontiguousarray(rcblob, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    nreads = lens.size
    ob = np.empty(blob.size + 16, np.uint8)
    cap = 2 * nreads + 2
    ol = np.empty(cap, np.int64)
    od = np.empty(cap, np.int64)
    osv = np.empty(cap, np.int64)
    oev = np.empty(cap, np.int64)
    obl = np.zeros(1, np.int64)
    nc = fn(sb.ctypes.data_as(i64p), sl.ctypes.data_as(i64p),
            runs.ctypes.data_as(i64p), indeg.ctypes.data_as(i64p),
            int(nverts2), blob.ctypes.data_as(u8p),
            rcblob.ctypes.data_as(u8p), starts.ctypes.data_as(i64p),
            lens.ctypes.data_as(i64p), nreads, int(min_depth),
            int(min_length), ob.ctypes.data_as(u8p),
            ol.ctypes.data_as(i64p), od.ctypes.data_as(i64p),
            osv.ctypes.data_as(i64p), oev.ctypes.data_as(i64p),
            obl.ctypes.data_as(i64p))
    return (ob[:int(obl[0])], ol[:nc], od[:nc], osv[:nc], oev[:nc])


def tyr_lookup_native(packed: np.ndarray, qfull: np.ndarray):
    """Threaded binary search over the packed big-endian .mer rows
    (gt_tyr_lookup). qfull: uint64 query keys already shifted to the
    padded code position. Returns (idx i64, hit bool) or None."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        fn = lib.gt_tyr_lookup
    except AttributeError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int64
        fn.argtypes = [u8p, ctypes.c_int64, ctypes.c_int, u8p,
                       ctypes.c_int64, ctypes.c_int, i64p, u8p]
    packed = np.ascontiguousarray(packed, np.uint8)
    nm, merbytes = packed.shape
    qb = np.ascontiguousarray(
        qfull.astype(">u8").view(np.uint8).reshape(-1, 8)[:, 8 - merbytes:])
    nq = qb.shape[0]
    idx = np.empty(nq, np.int64)
    hit = np.empty(nq, np.uint8)
    fn(packed.ctypes.data_as(u8p), nm, merbytes,
       qb.ctypes.data_as(u8p), nq, os.cpu_count() or 1,
       idx.ctypes.data_as(i64p), hit.ctypes.data_as(u8p))
    return idx, hit.astype(bool)
