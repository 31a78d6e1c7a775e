"""Batched greedy (front-prune) extension through K1, the resident K2
and K2.

Counterpart of ``genometools_tpu/ops/greedy_batch.py``
(``greedy_extend_batch``, ``greedy_extend_batch_pool`` and the
windowed chunk loop): the packed sequence pool is uploaded once
(``ops/pool.py``), and every window a kernel reads comes from it on the
device.

1. Each task whose flanks both fit K1's widest window runs whole in one
   launch of K1 (``ops/greedy_full.py``), which reads its flanks from the
   uploaded pool and moves a lane from the first slot tier to the next
   when its front touches the slot edge; lanes K1 leaves undone get one
   wide-slot rescue launch.
2. The lanes left over (flanks longer than 1,536, or undone) run the
   windowed chunk loop (``ops/chunk_loop.py``, the reference's
   greedy_batch.py:688-868): generation 0 is the seed's match run, then
   chunks of up to GENS generations in a W-symbol window, rebased around
   the live front between chunks, with the window tier (384 .. 24,576)
   and the slot tier (D = 16, 64) escalating or relaxing. By default the
   whole loop runs in one launch of the resident kernel
   (``ops/greedy_resident.py``), which holds every window tier.
   ``RESIDENT = False`` runs it host-driven instead (``_chunk_extend``),
   with K2 (``ops/greedy_chunk.py``), one launch per chunk.
3. What the chunk loop gives up on (``fallback``: slot spread beyond
   D = 64, the largest window exhausted, or MAX_CHUNKS chunks) is exact
   only on the host, so it goes to the C++ engine ``greedy_batch_native``.

``skip_chunked=True`` sends every lane K1 does not finish to the host
engine instead (step 2 is skipped). The default is the reference's,
False, and the port's seed_extend keeps it. That departs from the
reference's seed_extend, which skips the chunked route because on the
TPU a chunked subproblem cost seconds per wave (greedy_batch.py:505-509,
match/seed_extend.py:623-625); that cost does not carry over to the
H100, and the route changes where a lane runs, never its result.

Every lane is bit-exact against the scalar engine
``ops/greedy.py::greedy_extend``.

Spans (``genometools_torch.trace``): greedy.batch (lanes, symbols: the
flanks' total length) around a call, within it greedy.k1 (lanes,
symbols: their flanks' total length, undone: lanes that fit K1 and are
not finished there), greedy.rescue (lanes, symbols), greedy.resident
(lanes, gave_up: lanes the chunk loop left to the host; greedy.chunk on
the host-driven route) and greedy.host (lanes, symbols).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..core.native import greedy_batch_native
from ..device import resolve_device
from .chunk_loop import DONE, chunk_loop
from .greedy import PolishingInfo
from .greedy_chunk import greedy_chunk
from .greedy_full import check_history, greedy_full
from .greedy_resident import greedy_resident
from .pool import chunk_gen0, chunk_windows, pool_flanks, upload_pool

# lanes finished by K1, by the resident kernel and by the host-driven
# chunk loop with K2 (kernels or plain versions), and lanes routed to the
# host engine, summed over calls; reset with reset_stats()
stats = {"kernel_lanes": 0, "resident_lanes": 0, "chunk_lanes": 0,
         "host_lanes": 0}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


class GreedyBatchConfig:
    # K1: a task runs there when both flanks fit FULL_W symbols (0: no
    # K1; its window is its flanks rounded up to 32); slot tiers FULL_D,
    # a lane moving up on slot-edge contact; FULL_GENS generations at
    # most. The reference's passes ran every lane at D = 64; the first
    # tier, 16, holds the live front of seed_extend's default trims
    # (PERF.md).
    FULL_W = 1536
    FULL_D = (16, 64)
    FULL_GENS = 1536
    # one wide-slot retry (D, GENS) for lanes undone in K1 (None: none)
    RESCUE = (128, 6144)
    # the windowed chunk loop: window and slot tiers, chunks (per lane)
    # and lanes per K2 launch as in the reference; GENS is the port's
    # own, from a card measurement (PERF.md)
    W_TIERS = (384, 1536, 6144, 24576)
    D_TIERS = (16, 64)
    GENS = 384
    MAX_CHUNKS = 512
    CHUNK_WAVE = 131072
    # the chunk loop in the resident kernel (False: host-driven, with K2)
    RESIDENT = True


def _scores(errorpercentage, matchscore_bias, pol_info):
    if pol_info is not None:
        return pol_info.match_score, pol_info.difference_score
    match_score = int(20.0 * errorpercentage * matchscore_bias)
    return match_score, 1000 - match_score


def _mmp128(perc_mat_history: int) -> int:
    """percmathistory scaled to /128, rounded up."""
    return (perc_mat_history * 128) // 100 + \
        (0 if (perc_mat_history * 128) % 100 == 0 else 1)


def _chunk_extend(desc, lanes: np.ndarray, sc, cfg: GreedyBatchConfig,
                  gp: torch.Tensor):
    """The host-driven windowed chunk loop (ops/chunk_loop.py) with K2,
    one launch per chunk, over the given lanes. desc: the batch's
    (ustart, ulen, vstart, vlen, rev, seedlen) tensors on the device.
    Returns chunk_loop's result over `lanes`."""
    idx = torch.from_numpy(lanes).to(gp.device)
    su, ul, sv, vl, rv, slt = (a[idx] for a in desc)
    c0, state = chunk_gen0(gp, su, ul, sv, vl, rv, slt, sc[4],
                           cfg.D_TIERS[-1])
    # greedy_chunk is looked up here, at call time
    return chunk_loop(gp, (su, ul, sv, vl, rv), sc, c0, state, greedy_chunk,
                      chunk_windows, cfg.W_TIERS, cfg.D_TIERS, cfg.GENS,
                      cfg.MAX_CHUNKS, cfg.CHUNK_WAVE)


def _resident_extend(desc, lanes: np.ndarray, sc, cfg: GreedyBatchConfig,
                     gp: torch.Tensor) -> dict:
    """The resident kernel over the given lanes: chunk_loop's result, as
    numpy."""
    idx = torch.from_numpy(lanes).to(gp.device)
    out = greedy_resident(gp, *(a[idx] for a in desc), *sc, cfg.W_TIERS,
                          cfg.D_TIERS, cfg.GENS, cfg.MAX_CHUNKS)
    return {k: out[k].cpu().numpy() for k in ("best", "died", "route")}


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
    `fallback` (lanes the device left to the host engine: the
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

    def symbols(lanes=slice(None)) -> int:
        """The lanes' two flanks' total length (a span attribute)."""
        return int(u_len[lanes].sum() + v_len[lanes].sum())

    with trace.span("greedy.batch", lanes=N) as sp:
        if sp:
            sp.set(symbols=symbols())
        T = pool.size
        if gp is None:
            gp = upload_pool(pool, dev)
        starts_u = torch.from_numpy(np.where(rev, T - u_off - u_len, u_off))
        starts_v = torch.from_numpy(np.where(rev, T - v_off - v_len, v_off))
        desc = [t.to(dev) for t in (starts_u, torch.from_numpy(u_len),
                                    starts_v, torch.from_numpy(v_len),
                                    torch.from_numpy(rev),
                                    torch.from_numpy(sl))]

        def run(Fs, d_tiers, GENS):
            idx = torch.from_numpy(Fs).to(dev)
            out, _ = greedy_full(gp, *(a[idx] for a in desc), *sc,
                                 cfg.FULL_W, d_tiers, GENS)
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

        fits = (np.maximum(u_len, v_len) <= cfg.FULL_W) & (cfg.FULL_W > 0)
        Fs = np.flatnonzero(fits)
        if Fs.size:
            with trace.span("greedy.k1", lanes=int(Fs.size)) as k1:
                if k1:
                    k1.set(symbols=symbols(Fs))
                run(Fs, cfg.FULL_D, cfg.FULL_GENS)
                k1.set(undone=int((todo & fits).sum()))
        Fs = np.flatnonzero(todo & fits)
        if cfg.RESCUE is not None and Fs.size:
            with trace.span("greedy.rescue", lanes=int(Fs.size)) as rs:
                if rs:
                    rs.set(symbols=symbols(Fs))
                run(Fs, (cfg.RESCUE[0],), cfg.RESCUE[1])

        rest = np.flatnonzero(todo)
        if rest.size and not skip_chunked:
            extend, counter = (_resident_extend, "resident_lanes") \
                if cfg.RESIDENT else (_chunk_extend, "chunk_lanes")
            with trace.span("greedy.resident" if cfg.RESIDENT else
                            "greedy.chunk", lanes=int(rest.size)) as rs:
                out = extend(desc, rest, sc, cfg, gp)
                ok = out["route"] == DONE
                rs.set(gave_up=int(rest.size - ok.sum()))
            fin = rest[ok]
            for j, k in enumerate(("alignedlen", "row", "distance",
                                   "mismatches")):
                results[k][fin] = out["best"][ok, j]
            died[fin] = out["died"][ok]
            todo[fin] = False
            stats[counter] += int(fin.size)

        rest = np.flatnonzero(todo)
        fallback[rest] = True
        if rest.size:
            stats["host_lanes"] += int(rest.size)
            us, vs = pool_flanks(pool, u_off, u_len, v_off, v_len, rev, rest)
            pol = pol_info if pol_info is not None else \
                PolishingInfo.new(float(errorpercentage), history,
                                  matchscore_bias)
            with trace.span("greedy.host", lanes=int(rest.size),
                            symbols=symbols(rest)):
                res = greedy_batch_native(
                    us, vs, max_history=history,
                    perc_mat_history=perc_mat_history,
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
