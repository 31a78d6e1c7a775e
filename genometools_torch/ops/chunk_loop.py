"""The windowed chunk loop: long greedy extensions in W-symbol windows.

Counterpart of the reference's chunk loop
(``genometools_tpu/ops/greedy_batch.py:688-868``). Each lane starts
from its generation-0 state; a chunk advances it by up to GENS
generations in a window u[du:du+W], v[dv:dv+W]; between chunks the
window is rebased around the live front and the window tier (W) and
the slot tier (D) escalate, relax or widen by the reference's rules
(``rebase``). The chunk cap (MAX_CHUNKS) holds per lane, so a lane's
route does not depend on which lanes share its launches.

``chunk_loop`` runs these rules with a given chunk function: K2
(``ops/greedy_chunk.py``) for the chunk route, its plain version for the
plain version of the resident kernel (``ops/greedy_resident.py``), which
runs the same rules inside one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from .greedy_full import NEGINF

# a lane's route out of the loop
DONE, FALLBACK = 0, 1


def rebase(tier, dtier, d_before, d_after, rmin, rmax, cmin, kmin, kmax,
           W: int, Dw: int, n_tiers: int, dtiers):
    """The rebase rules of the reference's chunk loop, vectorised over
    lanes that did not finish a chunk at window tier W and slot tier Dw.
    Extremes are over the live slots: rows, columns and slot offsets
    k = s - Dw. Returns (shift, tier, dtier, fallback): the window moves
    by (rmin, cmin) and the slots by shift = cmin - rmin."""
    shift = cmin - rmin           # the new kbase is kbase + shift
    amax = np.maximum(np.abs(kmin - shift), np.abs(kmax - shift))
    # the smallest slot tier whose recentred window holds the live
    # spread (tiers both escalate and relax here)
    ndt = np.full(amax.size, -1)
    for j in range(len(dtiers) - 1, -1, -1):
        ndt[amax <= dtiers[j] - 1] = j
    fb = ndt < 0
    # no progress: the current match run crosses the whole window (or
    # the spread fills it), so no generation can commit — widen the slot
    # window if the spread is the limit, else go to the next, larger
    # window tier
    no_prog = (d_after == d_before) & (rmin == 0) & (cmin == 0)
    wider = ~fb & no_prog & (ndt < len(dtiers) - 1) & (amax >= Dw - 2)
    ndt[wider] += 1
    grow = ~fb & ~wider & (no_prog | (rmax - rmin >= W - 64))
    top = grow & (tier + 1 >= n_tiers)
    fb |= top
    tier = tier + (grow & ~top)
    # progress made: drop back toward the cheap window tier
    relax = ~fb & ~wider & ~grow & (tier > 0)
    tier = tier - relax
    return shift, tier, np.where(fb, dtier, ndt), fb


def chunk_loop(gp: torch.Tensor, desc, sc, c0, state, chunk_fn, window_fn,
               w_tiers, d_tiers, GENS: int, max_chunks: int,
               wave: int) -> dict:
    """Run lanes through the windowed chunk loop until they finish or
    fall back.

    desc: the lanes' (ustart, ulen, vstart, vlen, rev) tensors on the
    pool's device (starts in plane-set coordinates). sc: (mmp128, mad,
    match_score, difference_score, hist_cap). c0 and state: generation 0
    as pool.chunk_gen0 gives it at max(D) (the first match run, numpy,
    and the (row, h, hs, mm, valid) tensors). chunk_fn has K2's
    signature; window_fn(gp, *desc, du, dv, W) gives the (n, 6*W/32)
    window planes. Lanes per launch: at most `wave`.

    Returns numpy per lane: best (n, 4), died, route (DONE or FALLBACK)
    and chunks (chunks run)."""
    dev = gp.device
    tiers, dtiers = tuple(w_tiers), tuple(d_tiers)
    D = dtiers[-1]                    # the state is kept at max width
    K = 2 * D + 1
    su, ul, sv, vl, rv = desc
    ulen = ul.cpu().numpy()
    vlen = vl.cpu().numpy()
    row, h, hs, mm, valid = state
    du = np.array(c0, dtype=np.int64)
    dv = du.copy()
    n = du.size
    d_lane = np.zeros(n, np.int32)
    best = np.zeros((n, 4), np.int32)
    tier, dtier, chunks = (np.zeros(n, np.int64) for _ in range(3))
    died = np.zeros(n, bool)
    route = np.full(n, -1, np.int8)
    pending = np.arange(n)

    def up(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    while True:
        capped = chunks[pending] >= max_chunks
        route[pending[capped]] = FALLBACK
        pending = pending[~capped]
        if pending.size == 0:
            break
        # one launch per (window, slot) tier pair, lanes sorted by the
        # work left so that neighbouring warps are alike
        key = tier[pending] * len(dtiers) + dtier[pending]
        P = pending[key == key.min()]
        remaining = (ulen[P] - du[P]) + (vlen[P] - dv[P])
        P = P[np.argsort(remaining, kind="stable")][:wave]
        W = tiers[int(tier[P[0]])]
        Dw = dtiers[int(dtier[P[0]])]
        Kw = 2 * Dw + 1
        csl = slice(D - Dw, D + Dw + 1)
        urem = np.minimum(ulen[P] - du[P], 2 ** 30)
        vrem = np.minimum(vlen[P] - dv[P], 2 ** 30)
        kbase = dv[P] - du[P]
        ix = up(P, torch.int64)
        pw = window_fn(gp, su[ix], ul[ix], sv[ix], vl[ix], rv[ix],
                       up(du[P], torch.int64), up(dv[P], torch.int64), W)
        zero = torch.zeros(P.size, dtype=torch.bool, device=dev)
        out = chunk_fn(
            pw, row[ix, csl], h[ix, csl], hs[ix, csl], mm[ix, csl],
            valid[ix, csl], up(d_lane[P]), zero, zero, up(best[P]),
            up(urem), up(vrem), up(kbase), up(np.minimum(du[P], 2 ** 30)),
            *sc, W, Dw, GENS)
        chunks[P] += 1
        row_o, h_o, hs_o, mm_o, val_o, best_o, done_o, died_o, _, d_o = out
        # the rebase needs, per lane, the extremes of the live rows,
        # columns and slot offsets: fetched with the results in one copy
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
        died[P] = died_c != 0
        d_lane[P] = d_c
        route[P[done_c != 0]] = DONE
        # continuing lanes: rebase the window around the live front
        c = done_c == 0
        cont = P[c]
        rmin, rmax, cmin, kmin, kmax = (a[c] for a in
                                        (rmin, rmax, cmin, kmin, kmax))
        shift, tier[cont], ndt, fb = rebase(
            tier[cont], dtier[cont], d_before[c], d_c[c], rmin, rmax, cmin,
            kmin, kmax, W, Dw, len(tiers), dtiers)
        route[cont[fb]] = FALLBACK
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
            row[ig] = moved(row_o, NEGINF) - torch.where(v, rmin_t.view(-1, 1),
                                                       0)
            h[ig] = moved(h_o, 0)
            hs[ig] = moved(hs_o, 0)
            mm[ig] = moved(mm_o, 0)
            valid[ig] = v
            du[go] += rmin[ok]
            dv[go] += cmin[ok]
        pending = np.concatenate([pending[~np.isin(pending, P)], go])
    return dict(best=best, died=died, route=route, chunks=chunks)
