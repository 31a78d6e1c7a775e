"""The packed sequence pool on the device, and the windows and
generation-0 states the greedy kernels read from it.

Counterpart of the pool helpers in ``genometools_tpu/ops/greedy_batch.py``
(``pack_pool``, the pool-resident window gather) and of its host
generation 0 (``_host_lcp``, greedy_batch.py:701-716). The pool is
uploaded once (``upload_pool``). The persistent kernels K1, K2r and K3
read their windows from it themselves (``csrc/pool.cuh``;
``pool_windows_plain`` is the plain twin of that reader, and
``launch_pool_kernel`` launches K1 and K3 over a queue of lanes); K2 on
the host-driven chunk route takes windows gathered on the device
(``pk_from_pool``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _kernels
from .bits import M32, NEGINF, ctz32, from_i32_bits, to_i32_bits


def pack_codes(X: np.ndarray):
    """(lo, hi, special) bit-planes of a (N, W) uint8 code window as
    little-endian uint32 words (W/32 per row)."""
    def pb(bits):
        return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)
    return pb(X & 1 == 1), pb(X & 2 == 2), pb(X >= 4)


def pack_pool(pool: np.ndarray) -> np.ndarray:
    """(6, ceil(T/32)+2) uint32: lo/hi/special bit-planes of the pool and
    of the REVERSED pool (a reversed flank is a forward window in rows
    3..5). Trailing pad words are all special."""
    T = pool.size
    W32g = (T + 31) // 32 + 2
    out = np.zeros((6, W32g), np.uint32)

    def planes(x):
        padded = np.zeros(((T + 31) // 32) * 32, np.uint8)
        padded[:T] = x
        padded[T:] = 255
        return [np.packbits(b, bitorder="little").view(np.uint32)
                for b in (padded & 1 == 1, padded & 2 == 2, padded >= 4)]

    for base, x in ((0, pool), (3, pool[::-1])):
        lo, hi, sp = planes(x)
        out[base + 0, :lo.size] = lo
        out[base + 1, :hi.size] = hi
        out[base + 2, :sp.size] = sp
        out[base + 2, sp.size:] = 0xFFFFFFFF
    return out


def pool_flanks(pool: np.ndarray, u_off, u_len, v_off, v_len, rev, lanes):
    """(us, vs) code arrays of the given lanes, reversed where rev: the
    host engines' input."""
    us, vs = [], []
    for i in lanes:
        u = pool[u_off[i]:u_off[i] + u_len[i]]
        v = pool[v_off[i]:v_off[i] + v_len[i]]
        if rev[i]:
            u, v = u[::-1], v[::-1]
        us.append(u)
        vs.append(v)
    return us, vs


def upload_pool(pool: np.ndarray, device) -> torch.Tensor:
    """The pool's planes on the device, as int64 words."""
    return torch.from_numpy(pack_pool(pool).astype(np.int64)).to(device)


def pk_from_pool(gp: torch.Tensor, ustart, ulen, vstart, vlen, rev,
                 seedlen, W: int) -> torch.Tensor:
    """Gather the (N, 6*W/32+3) int32 task array from the uploaded pool
    (the host-driven chunk route's windows, and the kernels' first
    design's task arrays).
    Starts are in the chosen plane set's coordinates (reversed flanks
    at T - off - len of the reversed planes). Pad symbols beyond a
    flank are special with zero code bits; seedlen=None drops the
    seedlen column (the xdrop layout)."""
    W32 = W // 32
    dev = gp.device
    w = torch.arange(W32, device=dev).view(1, W32)
    rev = rev.view(-1, 1)
    qmax = gp.shape[1] - 2

    def side(start, length):
        q = ((start >> 5).view(-1, 1) + w).clamp(max=qmax)
        r = (start & 31).view(-1, 1)

        def fetch(pf, pr):
            w0 = torch.where(rev, gp[pr][q], gp[pf][q])
            w1 = torch.where(rev, gp[pr][q + 1], gp[pf][q + 1])
            return torch.where(r > 0, (w0 >> r) | ((w1 << (32 - r)) & M32),
                               w0)
        nb = (length.view(-1, 1) - 32 * w).clamp(0, 32)
        live = torch.where(nb >= 32, M32, (1 << nb.clamp(max=31)) - 1)
        return (fetch(0, 3) & live, fetch(1, 4) & live,
                fetch(2, 5) | (live ^ M32))

    cols = [*side(ustart, ulen), *side(vstart, vlen)]
    tail = [ulen.view(-1, 1), vlen.view(-1, 1)]
    if seedlen is not None:
        tail.insert(0, seedlen.view(-1, 1))
    return to_i32_bits(torch.cat(cols + tail, dim=1)).contiguous()


def seed_lcp(gp: torch.Tensor, ustart, ulen, vstart, vlen,
             rev) -> torch.Tensor:
    """Length of the exact match run at the start of each flank pair
    (wildcards never match): the reference's host generation 0
    (greedy_batch.py ``_host_lcp``), read from the uploaded pool 1,024
    symbols at a time. Starts are in the plane set's coordinates, as
    for pk_from_pool."""
    W = 1024
    W32 = W // 32
    c = torch.zeros_like(ustart)
    idx = torch.arange(ustart.numel(), device=ustart.device)
    w = torch.arange(W32, device=ustart.device).view(1, W32)
    while idx.numel():
        ci = c[idx]
        pk = pk_from_pool(gp, ustart[idx] + ci, ulen[idx] - ci,
                          vstart[idx] + ci, vlen[idx] - ci, rev[idx], None,
                          W)
        P = from_i32_bits(pk[:, :6 * W32]).view(-1, 6, W32)
        m = ~(P[:, 0] ^ P[:, 3]) & ~(P[:, 1] ^ P[:, 4]) & ~P[:, 2] & \
            ~P[:, 5] & M32
        first = torch.where(m == M32, W32, w).amin(dim=1, keepdim=True)
        word = torch.gather(m, 1, first.clamp(max=W32 - 1))
        run = 32 * first + torch.where(first < W32,
                                       ctz32(~word & M32), 0)
        c[idx] += run.view(-1)
        idx = idx[first.view(-1) == W32]
    return c


def seed_history(seed: np.ndarray, c0: np.ndarray, hist_cap: int):
    """Generation 0's centre slot: the seed's all-match history shifted
    by the first match run c0, as (h int64 bit patterns, hsize)."""
    ones = np.uint64(0xFFFFFFFFFFFFFFFF)
    sh = np.minimum(seed, 63).astype(np.uint64)
    h0 = np.where(seed >= 64, ones, (np.uint64(1) << sh) - np.uint64(1))
    cs = np.minimum(c0, 63).astype(np.uint64)
    h0 = np.where(c0 < 64,
                  (h0 << cs) | ((np.uint64(1) << cs) - np.uint64(1)), ones)
    return h0.view(np.int64), np.minimum(seed + c0, hist_cap)


def gen0_state(h0: torch.Tensor, hs0: torch.Tensor, D: int):
    """(row, h, hsize, mm, valid), a (n, 2D+1) slot state holding only
    the centre slot (row 0, history h0, hsize hs0)."""
    dev = h0.device
    n = h0.numel()
    K = 2 * D + 1
    i32 = dict(dtype=torch.int32, device=dev)
    row = torch.full((n, K), NEGINF, **i32)
    row[:, D] = 0
    h = torch.zeros((n, K), dtype=torch.int64, device=dev)
    h[:, D] = h0
    hs = torch.zeros((n, K), **i32)
    hs[:, D] = hs0.to(torch.int32)
    valid = torch.zeros((n, K), dtype=torch.bool, device=dev)
    valid[:, D] = True
    return row, h, hs, torch.zeros((n, K), **i32), valid


def chunk_gen0(gp: torch.Tensor, ustart, ulen, vstart, vlen, rev,
               seedlen, hist_cap: int, D: int):
    """The chunk loop's generation 0 (the reference's host generation
    0, greedy_batch.py:701-716): the seed's all-match history shifted by
    its first match run, at the centre of a (n, 2D+1) slot state on the
    pool's device; the window starts at the run's end. Returns c0 (the
    run length: the window origin in both u and v, numpy int64) and
    (row, h, hs, mm, valid)."""
    dev = gp.device
    seed = seedlen.cpu().numpy()
    c0 = seed_lcp(gp, ustart, ulen, vstart, vlen, rev).cpu().numpy()
    h0, hs0 = seed_history(seed, c0, hist_cap)
    return c0, gen0_state(torch.from_numpy(h0).to(dev),
                          torch.from_numpy(hs0).to(dev), D)


def chunk_windows(gp: torch.Tensor, ustart, ulen, vstart, vlen, rev, du,
                  dv, W: int) -> torch.Tensor:
    """K2's (n, 6*W/32) window planes, u[du:du+W] and v[dv:dv+W],
    gathered from the uploaded pool (du, dv: int64 tensors)."""
    pk = pk_from_pool(gp, ustart + du, ulen - du, vstart + dv, vlen - dv,
                      rev, None, W)
    return pk[:, :6 * (W // 32)].contiguous()


def pool_windows_plain(gp: torch.Tensor, ustart, ulen, vstart, vlen, rev,
                       du, dv, W: int) -> torch.Tensor:
    """The (n, 6*W/32) int32 window planes u[du:du+W], v[dv:dv+W] read
    from the pool as the kernels read them (csrc/pool.cuh load_window):
    word q = start >> 5 (capped at the last pool word), a funnel shift of
    the word pair (q, q+1) by start & 31, symbols past a flank special
    with zero code bits. Equals chunk_windows."""
    W32 = W // 32
    dev = gp.device
    qmax = gp.shape[1] - 2
    w = torch.arange(W32, device=dev).view(1, W32)
    plane = torch.where(rev.view(-1, 1), 3, 0)

    def side(start, length):
        q = ((start >> 5).view(-1, 1) + w).clamp(max=qmax)
        r = (start & 31).view(-1, 1)
        nb = (length.view(-1, 1) - 32 * w).clamp(0, 32)
        live = torch.where(nb >= 32, M32, (1 << nb.clamp(max=31)) - 1)
        words = []
        for p in range(3):
            pl = gp[(plane + p).expand_as(q), q]
            ph = gp[(plane + p).expand_as(q), q + 1]
            x = ((ph << 32) | pl) >> r & M32
            words.append(x | (live ^ M32) if p == 2 else x & live)
        return words

    return to_i32_bits(torch.cat(side(ustart + du, ulen - du)
                                 + side(vstart + dv, vlen - dv), dim=1))


def window_planes(gp: torch.Tensor, ustart, ulen, vstart, vlen, rev,
                  W: int) -> torch.Tensor:
    """(n, 6, W/32) int64 plane words of the lanes' windows at their
    flanks' starts (the plain versions' input)."""
    P = pool_windows_plain(gp, ustart, ulen, vstart, vlen, rev, 0, 0, W)
    return from_i32_bits(P).view(-1, 6, W // 32)


LANE_NAMES = ("ustart", "ulen", "vstart", "vlen", "rev", "seedlen")


def check_lanes(gp: torch.Tensor, desc, names=LANE_NAMES) -> None:
    """gp must be the (6, words) int64 pool planes and desc its lanes:
    ustart, ulen, vstart, vlen (int64), rev (bool)[, seedlen (int64)],
    one length, on gp's device."""
    if gp.dim() != 2 or gp.shape[0] != 6 or gp.dtype != torch.int64:
        raise ValueError("gp must be the (6, words) int64 pool planes")
    n = desc[0].numel()
    for name, t in zip(names, desc):
        dt = torch.bool if name == "rev" else torch.int64
        if tuple(t.shape) != (n,) or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} of shape ({n},), got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != gp.device:
            raise ValueError(f"{name} is on {t.device}, gp on {gp.device}")


def launch_pool_kernel(fn: str, gp: torch.Tensor, desc, conf,
                       out: torch.Tensor) -> torch.Tensor:
    """Launch the persistent kernel `fn` (gt_greedy_full, gt_xdrop_full)
    over the lanes desc on the pool gp (CUDA tensors): a warp takes lanes
    from a queue sorted longest first and writes lane t's result at
    out[:, t]. Returns the live slot-generations the launch counted,
    (1,) int64 on the device."""
    dev = gp.device
    gp = gp.contiguous()
    desc = [t.contiguous() for t in desc]
    n = desc[0].numel()
    order = torch.argsort(desc[1] + desc[3], descending=True,
                          stable=True).to(torch.int32)
    ctr = torch.zeros(1, dtype=torch.int32, device=dev)
    slot_gens = torch.zeros(1, dtype=torch.int64, device=dev)
    ptrs = (ctypes.c_void_p * len(desc))(*(t.data_ptr() for t in desc))
    conf_c = (ctypes.c_int * len(conf))(*conf)
    _kernels.call(fn, dev, gp.data_ptr(), gp.shape[1], ptrs,
                  order.data_ptr(), ctr.data_ptr(), out.data_ptr(),
                  slot_gens.data_ptr(), conf_c, n)
    return slot_gens


def kernel_occupancy(fn: str, conf) -> dict:
    """The occupancy of the kernel a conf launches (fn:
    gt_greedy_full_occupancy, gt_xdrop_full_occupancy,
    gt_greedy_resident_occupancy with a window width): resident warps per
    SM (4 warps a block), registers a thread, SMs."""
    out = (ctypes.c_int * 3)()
    arg = (ctypes.c_int * len(conf))(*conf) \
        if isinstance(conf, (list, tuple)) else int(conf)
    _kernels.check(getattr(_kernels.lib(), fn)(arg, out), fn)
    return {"warps_per_sm": out[0] * 4, "registers": out[1], "sms": out[2]}
