"""Batched greedy (front-prune) extension through K1 and K2.

Counterpart of ``genometools_tpu/ops/greedy_batch.py``
(``greedy_extend_batch``, ``greedy_extend_batch_pool`` and the
windowed chunk loop): the packed sequence pool is uploaded once
(``pack_pool``), and every window a kernel reads is gathered from it on
the device (``pk_from_pool``).

1. Each task whose flanks both fit a K1 window runs whole in K1
   (``ops/greedy_full.py``), in the first pass that holds it; lanes K1
   leaves undone get one wide rescue pass.
2. The lanes left over (flanks longer than 1,536, or undone) run in the
   windowed chunk loop (``_chunk_extend``, the reference's
   greedy_batch.py:688-868): generation 0 is the seed's match run, then
   K2 (``ops/greedy_chunk.py``) advances each lane by up to GENS
   generations per chunk in a W-symbol window, and the host rebases the
   window around the live front between chunks, escalating or relaxing
   the window tier (384 .. 24,576) and the slot tier (D = 16, 64).
3. What the chunk loop gives up on (``fallback``: slot spread beyond
   D = 64, the largest window exhausted, or MAX_CHUNKS) is exact only on
   the host, so it goes to the C++ engine ``greedy_batch_native``.

``skip_chunked=True`` sends every lane K1 does not finish to the host
engine instead (step 2 is skipped). The default is the reference's,
False, and the port's seed_extend keeps it. That departs from the
reference's seed_extend, which skips the chunked route because on the
TPU a chunked subproblem cost seconds per wave (greedy_batch.py:505-509,
match/seed_extend.py:623-625); that cost does not carry over to the
H100, and the route changes where a lane runs, never its result.

Every lane is bit-exact against the scalar engine
``ops/greedy.py::greedy_extend``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.native import greedy_batch_native
from ..device import resolve_device
from .bits import M32, ctz32, from_i32_bits, to_i32_bits
from .greedy import PolishingInfo
from .greedy_chunk import greedy_chunk
from .greedy_full import NEGINF, check_history, greedy_full

# lanes finished by K1 and by K2 (kernel or plain version) and lanes
# routed to the host engine, summed over calls; reset with reset_stats()
stats = {"kernel_lanes": 0, "chunk_lanes": 0, "host_lanes": 0}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


class GreedyBatchConfig:
    # (W, D, GENS) single-shot passes: a task runs in the first pass
    # whose window holds both flanks
    FULL_PASSES = ((256, 64, 1536), (384, 64, 1536), (768, 64, 1536),
                   (1536, 64, 1536))
    # one wide-slot retry for lanes undone at their pass (None: none)
    RESCUE = (1536, 128, 6144)
    # lanes per launch: bounds the gathered task array (1.2 KB a lane
    # at W=1536), not the kernel
    MAX_WAVE = 1 << 18
    # the windowed chunk loop (K2): window and slot tiers, chunks and
    # lanes per chunk launch as in the reference; GENS is the port's
    # own, from a card measurement (PERF.md)
    W_TIERS = (384, 1536, 6144, 24576)
    D_TIERS = (16, 64)
    GENS = 384
    MAX_CHUNKS = 512
    CHUNK_WAVE = 131072


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


def upload_pool(pool: np.ndarray, device) -> torch.Tensor:
    """The pool's planes on the device, as int64 words."""
    return torch.from_numpy(pack_pool(pool).astype(np.int64)).to(device)


def pk_from_pool(gp: torch.Tensor, ustart, ulen, vstart, vlen, rev,
                 seedlen, W: int) -> torch.Tensor:
    """Gather the (N, 6*W/32+3) int32 task array from the uploaded pool.
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


def _scores(errorpercentage, matchscore_bias, pol_info):
    if pol_info is not None:
        return pol_info.match_score, pol_info.difference_score
    match_score = int(20.0 * errorpercentage * matchscore_bias)
    return match_score, 1000 - match_score


def _mmp128(perc_mat_history: int) -> int:
    """percmathistory scaled to /128, rounded up."""
    return (perc_mat_history * 128) // 100 + \
        (0 if (perc_mat_history * 128) % 100 == 0 else 1)


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


def chunk_gen0(gp: torch.Tensor, ustart, ulen, vstart, vlen, rev,
               seedlen, hist_cap: int, D: int):
    """The chunk loop's generation 0 (the reference's host generation
    0, greedy_batch.py:701-716): the seed's all-match history shifted by
    its first match run, at the centre of a (n, 2D+1) slot state on the
    pool's device; the window starts at the run's end. Returns c0 (the
    run length: the window origin in both u and v, numpy int64) and
    (row, h, hsize, mm, valid)."""
    dev = gp.device
    n = ustart.numel()
    K = 2 * D + 1
    seed = seedlen.cpu().numpy()
    c0 = seed_lcp(gp, ustart, ulen, vstart, vlen, rev).cpu().numpy()
    ones = np.uint64(0xFFFFFFFFFFFFFFFF)
    sh = np.minimum(seed, 63).astype(np.uint64)
    h0 = np.where(seed >= 64, ones, (np.uint64(1) << sh) - np.uint64(1))
    cs = np.minimum(c0, 63).astype(np.uint64)
    h0 = np.where(c0 < 64,
                  (h0 << cs) | ((np.uint64(1) << cs) - np.uint64(1)), ones)
    i32 = dict(dtype=torch.int32, device=dev)
    row = torch.full((n, K), NEGINF, **i32)
    row[:, D] = 0
    h = torch.zeros((n, K), dtype=torch.int64, device=dev)
    h[:, D] = torch.from_numpy(h0.view(np.int64)).to(dev)
    hs = torch.zeros((n, K), **i32)
    hs[:, D] = torch.from_numpy(np.minimum(seed + c0, hist_cap)).to(dev)
    valid = torch.zeros((n, K), dtype=torch.bool, device=dev)
    valid[:, D] = True
    return c0, (row, h, hs, torch.zeros((n, K), **i32), valid)


def chunk_windows(gp: torch.Tensor, ustart, ulen, vstart, vlen, rev, du,
                  dv, W: int) -> torch.Tensor:
    """K2's (n, 6*W/32) window planes, u[du:du+W] and v[dv:dv+W],
    gathered from the uploaded pool (du, dv: int64 tensors)."""
    pk = pk_from_pool(gp, ustart + du, ulen - du, vstart + dv, vlen - dv,
                      rev, None, W)
    return pk[:, :6 * (W // 32)].contiguous()


def _chunk_extend(desc, lanes: np.ndarray, sc, hist_cap: int,
                  cfg: GreedyBatchConfig, gp: torch.Tensor):
    """The windowed chunk loop (the reference's greedy_batch.py:688-868)
    over the given lanes. desc: the batch's (ustart, ulen, vstart, vlen,
    rev, seedlen) tensors on the device. The (n, 2*max(D)+1) slot state
    stays on the device; the per-lane window origins (du, dv), tiers and
    results are numpy arrays, and each chunk's rebase is vectorised over
    its lanes. Returns (alignedlen, row, distance, mismatches, died,
    fallback) numpy arrays over `lanes`."""
    dev = gp.device
    tiers, dtiers = cfg.W_TIERS, cfg.D_TIERS
    D = dtiers[-1]                    # the state is kept at max width
    K = 2 * D + 1
    n = lanes.size
    idx_all = torch.from_numpy(lanes).to(dev)
    su, ul, sv, vl, rv, slt = (a[idx_all] for a in desc)
    ulen = ul.cpu().numpy()
    vlen = vl.cpu().numpy()
    du, (row, h, hs, mm, valid) = chunk_gen0(gp, su, ul, sv, vl, rv, slt,
                                             hist_cap, D)
    dv = du.copy()
    d_lane = np.zeros(n, np.int32)
    done = np.zeros(n, bool)
    died = np.zeros(n, bool)
    best = np.zeros((n, 4), np.int32)
    fallback = np.zeros(n, bool)
    tier = np.zeros(n, np.int64)      # index into W_TIERS, per lane
    dtier = np.zeros(n, np.int64)     # index into D_TIERS, per lane
    pending = np.arange(n)

    def up(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    for _ in range(cfg.MAX_CHUNKS):
        if pending.size == 0:
            break
        # one launch per (window, slot) tier pair, lanes sorted by the
        # work left so that neighbouring warps are alike
        key = tier[pending] * len(dtiers) + dtier[pending]
        P = pending[key == key.min()]
        remaining = (ulen[P] - du[P]) + (vlen[P] - dv[P])
        P = P[np.argsort(remaining, kind="stable")][:cfg.CHUNK_WAVE]
        W = tiers[int(tier[P[0]])]
        Dw = dtiers[int(dtier[P[0]])]
        Kw = 2 * Dw + 1
        csl = slice(D - Dw, D + Dw + 1)
        urem = np.minimum(ulen[P] - du[P], 2 ** 30)
        vrem = np.minimum(vlen[P] - dv[P], 2 ** 30)
        kbase = dv[P] - du[P]
        ix = up(P, torch.int64)
        pw = chunk_windows(gp, su[ix], ul[ix], sv[ix], vl[ix], rv[ix],
                           up(du[P], torch.int64), up(dv[P], torch.int64), W)
        out = greedy_chunk(
            pw, row[ix, csl], h[ix, csl],
            hs[ix, csl], mm[ix, csl], valid[ix, csl], up(d_lane[P]),
            up(done[P], torch.bool), up(died[P], torch.bool), up(best[P]),
            up(urem), up(vrem), up(kbase), up(np.minimum(du[P], 2 ** 30)),
            *sc, W, Dw, cfg.GENS)
        row_o, h_o, hs_o, mm_o, val_o, best_o, done_o, died_o, _, d_o = out
        # the rebase needs, per lane, the extremes of the live rows,
        # columns and diagonals: fetched with the results in one copy
        ks = torch.arange(Kw, device=dev).view(1, Kw) - Dw
        r64 = row_o.to(torch.int64)
        big = 1 << 40

        def ext(a, fn, fill):
            return fn(torch.where(val_o, a, fill), dim=1)

        lane_out = torch.stack(
            [*best_o.to(torch.int64).T, done_o.to(torch.int64),
             died_o.to(torch.int64), d_o.to(torch.int64),
             ext(r64, torch.amin, big), ext(r64, torch.amax, -big),
             ext(r64 + ks, torch.amin, big),
             ext(ks.expand_as(r64), torch.amin, big),
             ext(ks.expand_as(r64), torch.amax, -big)], dim=1).cpu().numpy()
        (b0, b1, b2, b3, done_c, died_c, d_c, rmin, rmax, cmin, kmin,
         kmax) = lane_out.T
        d_before = d_lane[P].copy()
        best[P] = np.stack([b0, b1, b2, b3], axis=1)
        done[P] = done_c != 0
        died[P] = died_c != 0
        d_lane[P] = d_c
        # continuing lanes: rebase the window around the live front
        c = done_c == 0
        cont = P[c]
        rmin, rmax, cmin, kmin, kmax = (a[c] for a in
                                        (rmin, rmax, cmin, kmin, kmax))
        shift = cmin - rmin           # the new kbase is kbase + shift
        amax = np.maximum(np.abs(kmin - shift), np.abs(kmax - shift))
        # the smallest slot tier whose recentred window holds the live
        # spread (tiers both escalate and relax here)
        ndt = np.full(cont.size, -1)
        for j in range(len(dtiers) - 1, -1, -1):
            ndt[amax <= dtiers[j] - 1] = j
        fb = ndt < 0
        # no progress: the current match run crosses the whole window (or
        # the spread fills it), so no generation can commit — widen the
        # slot window if the spread is the limit, else go to the next,
        # larger window tier
        no_prog = (d_c[c] == d_before[c]) & (rmin == 0) & (cmin == 0)
        wider = ~fb & no_prog & (ndt < len(dtiers) - 1) & (amax >= Dw - 2)
        ndt[wider] += 1
        grow = ~fb & ~wider & (no_prog | (rmax - rmin >= W - 64))
        top = grow & (tier[cont] + 1 >= len(tiers))
        fb |= top
        tier[cont[grow & ~top]] += 1
        # progress made: drop back toward the cheap window tier
        relax = ~fb & ~wider & ~grow & (tier[cont] > 0)
        tier[cont[relax]] -= 1
        fallback[cont[fb]] = True
        ok = ~fb
        go = cont[ok]
        dtier[go] = ndt[ok]
        if go.size:
            t_ok = up(np.flatnonzero(c)[ok], torch.int64)
            sh_t = up(shift[ok], torch.int64).view(-1, 1)
            src = torch.arange(K, device=dev).view(1, K) - (D - Dw) + sh_t
            inb = (src >= 0) & (src < Kw)
            srcc = src.clamp(0, Kw - 1)
            v = torch.gather(val_o[t_ok], 1, srcc) & inb

            def moved(a, fill):
                return torch.where(v, torch.gather(a[t_ok], 1, srcc), fill)
            ig = up(go, torch.int64)
            rmin_t = up(rmin[ok])
            row[ig] = moved(row_o, NEGINF) - torch.where(
                v, rmin_t.view(-1, 1), 0)
            h[ig] = moved(h_o, 0)
            hs[ig] = moved(hs_o, 0)
            mm[ig] = moved(mm_o, 0)
            valid[ig] = v
            du[go] += rmin[ok]
            dv[go] += cmin[ok]
        pending = np.concatenate([pending[~np.isin(pending, P)], go])
    fallback[pending] = True
    return (best[:, 0], best[:, 1], best[:, 2], best[:, 3],
            died & ~fallback, fallback)


def greedy_extend_batch_pool(pool: np.ndarray, u_off, u_len, v_off, v_len,
                             rev, *, seedlengths, perc_mat_history: int,
                             maxalignedlendifference: int,
                             errorpercentage: float = 0.0,
                             history: int = 64, matchscore_bias: float = 1.0,
                             pol_info=None,
                             cfg: GreedyBatchConfig | None = None,
                             device="cuda", gp: torch.Tensor | None = None,
                             skip_chunked: bool = False):
    """Task i extends u = pool[u_off:u_off+u_len] against
    v = pool[v_off:v_off+v_len], both read reversed when rev[i] (left
    flanks). Returns int32 alignedlen/row/distance/mismatches, `died`,
    `fallback` (lanes the device left to the host engine: the chunk
    chunk loop gave up on them, or skip_chunked) and `touched` (a
    host-routed lane whose live front reached the end of a flank: a
    caller that clipped the flanks re-runs it wider).
    gp: the pool already uploaded with upload_pool (saves the upload)."""
    check_history(history)
    cfg = cfg or GreedyBatchConfig()
    dev = resolve_device(device)
    N = int(np.asarray(u_off).size)
    u_off = np.asarray(u_off, np.int64)
    u_len = np.asarray(u_len, np.int64)
    v_off = np.asarray(v_off, np.int64)
    v_len = np.asarray(v_len, np.int64)
    rev = np.asarray(rev, bool)
    sl = np.asarray(seedlengths, np.int64)
    if sl.ndim == 0:
        sl = np.full(N, int(sl), np.int64)
    match_score, difference_score = _scores(errorpercentage,
                                            matchscore_bias, pol_info)
    sc = (_mmp128(perc_mat_history), int(maxalignedlendifference),
          int(match_score), int(difference_score), int(history))
    results = {k: np.zeros(N, np.int32) for k in
               ("alignedlen", "row", "distance", "mismatches")}
    died = np.zeros(N, bool)
    touched = np.zeros(N, bool)
    fallback = np.zeros(N, bool)
    todo = np.ones(N, bool)
    if N == 0:
        return dict(results, died=died, fallback=fallback, touched=touched)
    T = pool.size
    if gp is None:
        gp = upload_pool(pool, dev)
    starts_u = torch.from_numpy(np.where(rev, T - u_off - u_len, u_off))
    starts_v = torch.from_numpy(np.where(rev, T - v_off - v_len, v_off))
    desc = [t.to(dev) for t in (starts_u, torch.from_numpy(u_len), starts_v,
                                torch.from_numpy(v_len),
                                torch.from_numpy(rev), torch.from_numpy(sl))]

    def run(Fs, W, D, GENS):
        idx = torch.from_numpy(Fs).to(dev)
        pk = pk_from_pool(gp, *(a[idx] for a in desc[:4]), desc[4][idx],
                          desc[5][idx], W)
        return greedy_full(pk, *sc, W, D, GENS)

    def collect(Fs, out):
        out = out.cpu().numpy()
        done_o = out[4] != 0
        fin = Fs[done_o]
        results["alignedlen"][fin] = out[0][done_o]
        results["row"][fin] = out[1][done_o]
        results["distance"][fin] = out[2][done_o]
        results["mismatches"][fin] = out[3][done_o]
        died[fin] = out[5][done_o] != 0
        todo[fin] = False
        stats["kernel_lanes"] += int(fin.size)

    maxlen = np.maximum(u_len, v_len)
    assigned = ~((u_len >= 1) & (v_len >= 1))
    pending = []
    for W0, Df, Gf in cfg.FULL_PASSES:
        sel = ~assigned & (maxlen <= W0)
        assigned |= sel
        fast = np.flatnonzero(sel)
        # length-sorted lanes keep neighbouring warps similar in length
        fast = fast[np.argsort(u_len[fast] + v_len[fast], kind="stable")]
        for s in range(0, fast.size, cfg.MAX_WAVE):
            Fs = fast[s:s + cfg.MAX_WAVE]
            pending.append((Fs, run(Fs, W0, Df, Gf)))
    for Fs, out in pending:
        collect(Fs, out)
    if cfg.RESCUE is not None:
        Wr, Dr, Gr = cfg.RESCUE
        Fs = np.flatnonzero(todo & (maxlen <= Wr))
        if Fs.size:
            collect(Fs, run(Fs, Wr, Dr, Gr))

    rest = np.flatnonzero(todo)
    if rest.size and not skip_chunked:
        al, row, dist, mism, died_c, fb = _chunk_extend(
            desc, rest, sc, int(history), cfg, gp)
        fin = ~fb
        for k, v in (("alignedlen", al), ("row", row), ("distance", dist),
                     ("mismatches", mism)):
            results[k][rest[fin]] = v[fin]
        died[rest[fin]] = died_c[fin]
        todo[rest[fin]] = False
        stats["chunk_lanes"] += int(fin.sum())

    rest = np.flatnonzero(todo)
    fallback[rest] = True
    if rest.size:
        stats["host_lanes"] += int(rest.size)
        us, vs = pool_flanks(pool, u_off, u_len, v_off, v_len, rev, rest)
        pol = pol_info if pol_info is not None else \
            PolishingInfo.new(float(errorpercentage), history,
                              matchscore_bias)
        res = greedy_batch_native(
            us, vs, max_history=history, perc_mat_history=perc_mat_history,
            maxalignedlendifference=maxalignedlendifference,
            seedlengths=sl[rest], pol=pol)
        if res is None:
            raise RuntimeError("the native host engine is unavailable")
        results["alignedlen"][rest] = res[:, 0]
        results["row"][rest] = res[:, 1]
        results["distance"][rest] = res[:, 2]
        results["mismatches"][rest] = res[:, 3]
        died[rest] = res[:, 4] != 0
        touched[rest] = res[:, 5] != 0
    return dict(results, died=died, fallback=fallback, touched=touched)


def greedy_extend_batch(us, vs, **kw):
    """Array form of greedy_extend_batch_pool: task i extends us[i]
    against vs[i] (both read forward)."""
    lens_u = np.asarray([len(u) for u in us], np.int64)
    lens_v = np.asarray([len(v) for v in vs], np.int64)
    parts = [np.asarray(x, np.uint8) for x in list(us) + list(vs)]
    pool = np.concatenate(parts) if parts else np.zeros(1, np.uint8)
    if pool.size == 0:
        pool = np.zeros(1, np.uint8)
    u_off = np.cumsum(lens_u) - lens_u
    v_off = int(lens_u.sum()) + np.cumsum(lens_v) - lens_v
    return greedy_extend_batch_pool(pool, u_off, lens_u, v_off, lens_v,
                                    np.zeros(len(us), bool), **kw)
