"""K1: single-shot greedy front-prune extension, one task per lane.

Replaces the Pallas kernel ``genometools_tpu/ops/greedy_pallas.py``
``_make_kernel(single_shot=True)`` launched by ``_full_pallas`` /
``greedy_full_pallas`` (``pl.pallas_call`` at greedy_pallas.py:531).
It runs a whole greedy extension (ref: ft-front-prune.c:633
front_prune_edist_inplace plus the ft-polish.c polishing test) for
every lane whose flanks both fit a W-symbol window: generation 0 is
built in the kernel (the seed's all-match history and its first match
run), then each generation extends the K = 2D+1 diagonal slots by
their match runs, picks the best predecessor (ins > mis > del on row
ties), shifts the 64-bit match history, trims by percmathistory and
maxalignedlendifference, and walks the 2x15-bit polishing test. Lanes
that touch the slot edge of the last slot tier, or reach the
generation cap, come back undone.

Input: the uploaded pool (``ops/pool.py``) and per lane ustart, ulen,
vstart, vlen, rev, seedlen, read by the kernel itself. Slot tiers
d_tiers: a lane starts at the first and moves to the next when its
front touches the slot edge; the paused generation was not committed,
so it goes on from its state, widened, with the generations it has
left. Result: (7, N) int32 (best alignedlen, row, distance,
mismatches, then done, died, undone) and the live slot-generations of
the run.

On the card (csrc/greedy_full.cu) warps persist and take lanes from a
queue, longest first; a lane is one warp, the K slots spread over the
32 threads (slot s = 32*g + lane), slot shifts are warp shuffles,
reductions and first-occurrence argmax are warp reductions, and the
history is a native uint64_t. The match words are computed on the fly
from the lane's window planes, read from the pool into shared memory;
the (W/32, K, N) match bitmask of the TPU kernel is never built. The
kernel is bound by the serial generation chain of each lane (integer
and shuffle instructions), not by memory.

The plain version below is lane-vectorised over (N, K) with a Python
generation loop; it materialises the match words and is meant for CPU
tests and for checking the kernel.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .bits import (M32, NEGINF, ctz32, ones64, polish_walk, popcount64,
                   shl64)
from .pool import (check_lanes, kernel_occupancy, launch_pool_kernel,
                   window_planes)
UNROLL = 4          # the reference checks its generation cap every 4

launches = 0        # kernel launches (the CUDA path only)
# the work of those launches, for the kernel's bound: live
# slot-generations, and bytes moved (pool planes, lane descriptors and
# outputs, each once)
work = {"slot_gens": 0, "bytes": 0}


def check_history(hist_cap: int) -> None:
    if not 30 <= int(hist_cap) <= 64:
        # cut_depth shrinks below 15 for history < 30; not mirrored
        raise NotImplementedError("device greedy batch requires a match "
                                  "history size in [30, 64]")


def gens_cap(GENS: int) -> int:
    """Generations a lane may run: the reference tests `t < GENS` once
    per UNROLL generations."""
    return -(-int(GENS) // UNROLL) * UNROLL


def match_words(P: torch.Tensor, W: int, D: int) -> torch.Tensor:
    """(N, K, W32) match words from the (N, 6, W32) planes: bit b of word
    w of slot s is U[i] == V[i + s - D] at i = 32w + b, with neither
    symbol special; V positions outside [0, W) never match (the TPU
    kernel's M, lane-major). Slots with equal word offset (s - D) >> 5
    shift together."""
    N, _, W32 = P.shape
    K = 2 * D + 1
    dev = P.device
    pad = D // 32 + 2

    def padded(x, fill):
        edge = torch.full((N, pad), fill, dtype=x.dtype, device=dev)
        return torch.cat([edge, x, edge], dim=1)

    ulo, uhi, usp = (P[:, i].unsqueeze(1) for i in range(3))
    vplanes = [padded(P[:, 3], 0), padded(P[:, 4], 0), padded(P[:, 5], M32)]
    out = torch.empty(N, K, W32, dtype=P.dtype, device=dev)
    ks = torch.arange(K) - D
    for q in torch.unique(ks >> 5).tolist():
        sel = torch.nonzero((ks >> 5) == q).squeeze(1)
        r = (ks[sel] - 32 * q).to(dev).view(1, -1, 1)
        o = pad + q

        def shifted(vp):
            v0 = vp[:, o:o + W32].unsqueeze(1)
            v1 = vp[:, o + 1:o + 1 + W32].unsqueeze(1)
            hi = torch.where(r > 0, (v1 << (32 - r).clamp(1, 31)) & M32, 0)
            return (v0 >> r) | hi
        vlo, vhi, vsp = (shifted(vp) for vp in vplanes)
        out[:, sel.to(dev)] = ~(ulo ^ vlo) & ~(uhi ^ vhi) & ~usp & ~vsp \
            & M32
    return out


def match_run(M: torch.Tensor, row: torch.Tensor,
              live: torch.Tensor) -> torch.Tensor:
    """(N, K) length of the match run from `row` on each live slot's
    diagonal (0 elsewhere; live slots need 0 <= row < W). Read 32 bits
    at a time, as the kernels do; only slots whose run goes on are
    visited again."""
    N, K, W32 = M.shape
    words = M.reshape(N * K, W32)
    total = torch.zeros_like(row)
    flat = total.view(-1)
    idx = live.reshape(-1).nonzero().squeeze(1)
    r = row.reshape(-1)[idx]

    def word(wi):
        v = words[idx, wi.clamp(max=W32 - 1)]
        return torch.where(wi < W32, v, torch.zeros_like(v))

    while idx.numel():
        wi = r >> 5
        off = r & 31
        # (w1 << 32) & M32 is 0, so off = 0 needs no special case
        bits = (word(wi) >> off) | ((word(wi + 1) << (32 - off)) & M32)
        c = ctz32(bits ^ M32)
        flat[idx] += c
        more = c == 32
        idx, r = idx[more], r[more] + 32
    return total


def front_plain(P: torch.Tensor, st: dict, sc: tuple, W: int, D: int,
                GENS: int, run_first: bool, counts: dict | None = None,
                cap: int | None = None) -> dict:
    """The front recurrence of K1 and K2, lane-vectorised over (N, K).

    P: (N, 6, W32) plane words of the U and V windows. st: the input
    state — per slot (N, K): row, hlo, hhi, hs, mm (int64), valid
    (bool); per lane (N, 1): d_lane, urem, vrem, kbase, rowbase (int64),
    done, died (bool), best (a list of four int64 columns: alignedlen,
    row, distance, mismatches). Rows and diagonals are relative to the
    window (kbase = dv - du, rowbase = du); alignedlen is absolute
    (albase = 2*rowbase + kbase). sc: (mmp128, mad, match_score,
    difference_score, hist_cap, cut_depth).

    The input state is scored first (trim, polished point, completion;
    idempotent on a scored state), after one match run when run_first
    (K1's generation 0); then up to gens_cap(GENS) generations run. A
    generation whose front touches the window or the slot edge is
    rolled back and the lane pauses. Returns the same keys plus
    `paused` (N, 1). counts, when a dict, gains under "slot_gens" the
    live slots summed over every lane's generations (the work the
    data needs, for a kernel's operation bound). cap: a lane runs no
    generation once d_lane reaches it (K1's later slot tiers)."""
    mmp128, mad, match_score, difference_score, hist_cap, cut_depth = sc
    dev = P.device
    N, _, W32 = P.shape
    K = 2 * D + 1
    pol_size = 2 * cut_depth
    sidx = torch.arange(K, device=dev).view(1, K)
    karr = sidx - D
    hmask_lo, hmask_hi = ones64(torch.tensor(hist_cap, device=dev))
    i64 = dict(dtype=torch.int64, device=dev)
    # the polishing walk of every cut_depth-bit prefix, looked up per slot
    pol_dfm, pol_ss = polish_walk(torch.arange(1 << cut_depth, **i64),
                                  match_score, difference_score, cut_depth)
    # s: the working set (lanes still running); per-lane constants ride
    # along so that finished lanes can be dropped from every array
    s = dict(st)
    s["M"] = match_words(P, W, D)
    s["ulen_c"] = s["urem"].clamp(max=W)
    s["vlen_c"] = s["vrem"].clamp(max=W)
    s["u_more"] = s["urem"] > W
    s["v_more"] = s["vrem"] > W
    s["albase"] = 2 * s["rowbase"] + s["kbase"]
    best = s.pop("best")
    s.update({f"best{i}": b for i, b in enumerate(best)})

    def add_matches(row, hlo, hhi, hs, valid):
        # a run of c matches shifts c ones into the history: the kernel
        # does it 32 at a time, which composes to one shift by the total
        c = match_run(s["M"], row, valid & (row >= 0) & (row < W))
        olo, ohi = ones64(c)
        slo, shi = shl64(hlo, hhi, c)
        return (row + c, slo | olo, shi | ohi,
                (hs + c).clamp(max=hist_cap))

    def first_slot(mask):
        return torch.where(mask, sidx, K).amin(dim=1, keepdim=True)

    def take(a, idx):
        return torch.gather(a, 1, idx)

    def trim_and_score(row, hlo, hhi, hs, mm, valid, d, best, done):
        rsafe = row.clamp(min=0)
        alignedlen = torch.where(valid, 2 * rsafe + karr + s["albase"],
                                 NEGINF)
        maxal = alignedlen.amax(dim=1, keepdim=True)
        minlen = (maxal - mad).clamp(min=0)
        need = (hs * mmp128) >> 7
        keep = valid & (row <= s["ulen_c"]) & \
            (row + karr <= s["vlen_c"]) & (alignedlen >= minlen) & \
            (popcount64(hlo & hmask_lo, hhi & hmask_hi) >= need)
        anyk = keep.any(dim=1, keepdim=True)
        first = first_slot(keep)
        last = torch.where(keep, sidx, -1).amax(dim=1, keepdim=True)
        valid = valid & (sidx >= first) & (sidx <= last) & anyk
        died_now = ~anyk & ~done

        fill = (pol_size - hs).clamp(min=0)
        flo, fhi = ones64(fill)
        slo, _ = shl64(flo, fhi, hs.clamp(max=64))
        filled_lo = hlo | slo
        p_lo = filled_lo & 0x7FFF
        p_hi = (filled_lo >> cut_depth) & 0x7FFF
        polished = (pol_dfm[p_lo] >= 0) & (pol_ss[p_lo] + pol_dfm[p_hi] >= 0)
        cand = torch.where(valid & polished & ~done, alignedlen, NEGINF)
        cbest = cand.amax(dim=1, keepdim=True)
        fidx = first_slot(cand == cbest)
        better = cbest > best[0]
        best = [torch.where(better, cbest, best[0]),
                torch.where(better, take(rsafe, fidx) + s["rowbase"],
                            best[1]),
                torch.where(better, d, best[2]),
                torch.where(better, take(mm, fidx), best[3])]

        # completion: the front reaches (urem, vrem) on the end diagonal
        urem, vrem = s["urem"], s["vrem"]
        e_rel = vrem - urem
        eidx = (e_rel + D).clamp(0, K - 1)
        inband = (e_rel >= -D) & (e_rel <= D)
        ok_k = ((e_rel + s["kbase"]).abs() <= d) & inband & \
            take(valid, eidx) & \
            (take(row, eidx) == torch.where(inband, urem, NEGINF))
        complete_now = ok_k & ~done
        return valid, best, died_now, complete_now

    def sh(a, fill, off):
        """off=+1: slot s reads slot s-1; off=-1: slot s reads s+1."""
        pad = torch.full_like(a[:, :1], fill)
        if off == 1:
            return torch.cat([pad, a[:, :-1]], dim=1)
        return torch.cat([a[:, 1:], pad], dim=1)

    def bests():
        return [s[f"best{i}"] for i in range(4)]

    def set_bests(b):
        s.update({f"best{i}": x for i, x in enumerate(b)})

    if run_first:
        s["row"], s["hlo"], s["hhi"], s["hs"] = add_matches(
            s["row"], s["hlo"], s["hhi"], s["hs"], s["valid"])
    s["valid"], b, died_now, complete_now = trim_and_score(
        s["row"], s["hlo"], s["hhi"], s["hs"], s["mm"], s["valid"],
        s["d_lane"], bests(), s["done"])
    set_bests(b)
    s["died"] = s["died"] | died_now
    s["done"] = s["done"] | died_now | complete_now
    s["paused"] = torch.zeros_like(s["done"])

    # a lane that is done or paused has its final state: write it to
    # `final` and drop the lane from the working set once half are idle
    out_keys = ("row", "hlo", "hhi", "hs", "mm", "valid", "d_lane", "done",
                "died", "paused", "best0", "best1", "best2", "best3")
    final = {k: s[k].clone() for k in out_keys}
    lanes = torch.arange(N, device=dev)

    def flush(mask):
        for k in out_keys:
            final[k][lanes[mask]] = s[k][mask]

    for _ in range(gens_cap(GENS)):
        act = ~s["done"] & ~s["paused"]
        if cap is not None:
            act &= s["d_lane"] < cap
        nact = int(act.sum())
        if nact == 0:
            break
        if nact <= lanes.numel() // 2:
            flush(~act[:, 0])
            keep = act[:, 0]
            lanes = lanes[keep]
            for k in s:
                s[k] = s[k][keep]
            act = act[keep]
        row, hlo, hhi, hs, mm, valid = (s[k] for k in (
            "row", "hlo", "hhi", "hs", "mm", "valid"))
        v_ins = sh(valid, False, 1)
        v_del = sh(valid, False, -1)
        r_ins = torch.where(v_ins, sh(row, 0, 1), NEGINF)
        r_mis = torch.where(valid, row + 1, NEGINF)
        r_del = torch.where(v_del, sh(row, 0, -1) + 1, NEGINF)
        r_new = torch.maximum(torch.maximum(r_ins, r_mis), r_del)
        anyc = r_new > NEGINF
        if counts is not None:
            counts["slot_gens"] = counts.get("slot_gens", 0) + \
                int((anyc & act).sum())
        use_ins = v_ins & (r_ins == r_new)
        use_mis = valid & (r_mis == r_new) & ~use_ins
        use_del = v_del & (r_del == r_new) & ~use_ins & ~use_mis

        def pick3(a, fill):
            return torch.where(use_ins, sh(a, fill, 1),
                               torch.where(use_mis, a,
                                           torch.where(use_del,
                                                       sh(a, fill, -1),
                                                       fill)))

        hlo_n = pick3(hlo, 0)
        hhi_n = pick3(hhi, 0)
        hs_n = pick3(hs, 0)
        mm_ins = torch.where(v_ins & (r_ins == r_new), sh(mm, 0, 1), NEGINF)
        mm_mis = torch.where(valid & (r_mis == r_new), mm + 1, NEGINF)
        mm_del = torch.where(v_del & (r_del == r_new), sh(mm, 0, -1),
                             NEGINF)
        # a deletion's mismatch count only when it wins outright
        # (ref: ft-front-prune.c:395-407)
        mm_im = torch.maximum(mm_ins, mm_mis)
        mm_n = torch.where(mm_im > NEGINF, mm_im, mm_del)
        hs_n = (hs_n + 1).clamp(max=hist_cap)
        hlo_n, hhi_n = shl64(hlo_n, hhi_n, torch.ones((), **i64))
        row_n = torch.where(anyc, r_new, NEGINF)
        row_n, hlo_n, hhi_n, hs_n = add_matches(row_n, hlo_n, hhi_n, hs_n,
                                                anyc)
        contact = (anyc & ((s["u_more"] & (row_n >= W))
                           | (s["v_more"] & (row_n + karr >= W))
                           | (sidx <= 0) | (sidx >= K - 1))) \
            .any(dim=1, keepdim=True)
        pause_now = act & contact
        commit = act & ~contact
        d_next = torch.where(commit, s["d_lane"] + 1, s["d_lane"])
        valid_n, best_n, died_now, complete_now = trim_and_score(
            row_n, hlo_n, hhi_n, hs_n, mm_n, anyc, d_next, bests(),
            s["done"] | pause_now | ~act)
        for k, v in (("row", row_n), ("hlo", hlo_n), ("hhi", hhi_n),
                     ("hs", hs_n), ("mm", mm_n), ("valid", valid_n)):
            s[k] = torch.where(commit, v, s[k])
        set_bests([torch.where(commit, bn, b)
                   for bn, b in zip(best_n, bests())])
        s["died"] = s["died"] | (commit & died_now)
        s["done"] = s["done"] | (commit & (died_now | complete_now))
        s["paused"] = s["paused"] | pause_now
        s["d_lane"] = d_next

    flush(torch.ones_like(lanes, dtype=torch.bool))
    final["best"] = [final.pop(f"best{i}") for i in range(4)]
    return final


def _widen(f: dict, sel: torch.Tensor, D0: int, D1: int) -> dict:
    """The state of the lanes sel of a front_plain result at slot tier
    D0, recentred at D1 > D0 (new slot s holds old slot s - (D1 - D0);
    slots from outside tier 0 are invalid), as the kernel widens it."""
    off = D1 - D0
    valid = f["valid"][sel]
    m, K0 = valid.shape

    def pad(x, fill):
        out = torch.full((m, 2 * D1 + 1), fill, dtype=x.dtype,
                         device=x.device)
        out[:, off:off + K0] = torch.where(valid, x[sel], fill)
        return out
    st = {k: pad(f[k], fill) for k, fill in (
        ("row", NEGINF), ("hlo", 0), ("hhi", 0), ("hs", 0), ("mm", 0),
        ("valid", False))}
    st.update({k: f[k][sel] for k in ("d_lane", "done", "died")})
    st["best"] = [b[sel] for b in f["best"]]
    return st


def greedy_full_plain(gp: torch.Tensor, ustart, ulen, vstart, vlen, rev,
                      seedlen, mmp128: int, mad: int, match_score: int,
                      difference_score: int, hist_cap: int, W: int,
                      d_tiers, GENS: int, cut_depth: int = 15,
                      counts: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of K1 (same inputs and (7, N) result); every
    lane's window is W symbols (the kernel rounds a lane's flanks up to
    32 instead: a window that holds both flanks gives the same result).
    counts: see front_plain."""
    dev = gp.device
    N = ustart.numel()
    P = window_planes(gp, ustart, ulen, vstart, vlen, rev, W)
    seedl = seedlen.view(N, 1)
    i64 = dict(dtype=torch.int64, device=dev)
    sc = (mmp128, mad, match_score, difference_score, hist_cap, cut_depth)
    # generation 0: the seed's all-match history at the centre slot
    D0 = d_tiers[0]
    K = 2 * D0 + 1
    center = (torch.arange(K, device=dev) == D0).view(1, K).expand(N, K)
    slo0, shi0 = ones64(seedl)
    zero = torch.zeros(N, 1, **i64)
    false = torch.zeros(N, 1, dtype=torch.bool, device=dev)
    urem, vrem = ulen.view(N, 1), vlen.view(N, 1)
    st = dict(row=torch.where(center, 0, NEGINF).to(torch.int64),
              hlo=torch.where(center, slo0, 0),
              hhi=torch.where(center, shi0, 0),
              hs=torch.where(center, seedl.clamp(max=hist_cap), 0),
              mm=torch.zeros(N, K, **i64), valid=center.clone(),
              d_lane=zero, done=false, died=false, urem=urem, vrem=vrem,
              kbase=zero, rowbase=zero, best=[zero] * 4)
    f = front_plain(P, st, sc, W, D0, GENS, True, counts)
    res = {"best": [b.clone() for b in f["best"]], "done": f["done"].clone(),
           "died": f["died"].clone()}
    lanes = torch.arange(N, device=dev)
    # lanes paused at a slot tier's edge go on at the next tier
    for D1 in d_tiers[1:]:
        sel = (f["paused"] & ~f["done"]).view(-1)
        if not bool(sel.any()):
            break
        lanes = lanes[sel]
        st = _widen(f, sel, D0, D1)
        st.update(urem=urem[lanes], vrem=vrem[lanes], kbase=zero[lanes],
                  rowbase=zero[lanes])
        f = front_plain(P[lanes], st, sc, W, D1, GENS, False, counts,
                        cap=gens_cap(GENS))
        for i in range(4):
            res["best"][i][lanes] = f["best"][i]
        res["done"][lanes] = f["done"]
        res["died"][lanes] = f["died"]
        D0 = D1
    done_i = res["done"].to(torch.int64)
    out = torch.cat([*res["best"], done_i,
                     res["died"].to(torch.int64) & done_i, 1 - done_i],
                    dim=1)
    return out.T.contiguous().to(torch.int32)


def greedy_full(gp: torch.Tensor, ustart, ulen, vstart, vlen, rev, seedlen,
                mmp128: int, mad: int, match_score: int,
                difference_score: int, hist_cap: int, W: int, d_tiers,
                GENS: int, cut_depth: int = 15):
    """K1 on the pool's device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. W: the widest window (a lane longer
    than it pauses at the window and comes back undone). Returns the
    (7, N) int32 result and the live slot-generations, (1,) int64, both
    on that device."""
    check_history(hist_cap)
    d_tiers = tuple(int(D) for D in d_tiers)
    if W % 32 or W <= 0 or not d_tiers or GENS < 0 or \
            not all(1 <= D <= 143 for D in d_tiers) or \
            list(d_tiers) != sorted(set(d_tiers)):
        raise ValueError(f"unsupported shape W={W} d_tiers={d_tiers} "
                         f"GENS={GENS}")
    if cut_depth != 15:
        raise NotImplementedError("cut_depth 15 only (history >= 30)")
    desc = (ustart, ulen, vstart, vlen, rev, seedlen)
    check_lanes(gp, desc)
    sc = (int(mmp128), int(mad), int(match_score), int(difference_score),
          int(hist_cap))
    if gp.device.type == "cpu":
        cnt = {}
        out = greedy_full_plain(gp, *desc, *sc, W, d_tiers, GENS,
                                cut_depth, counts=cnt)
        return out, torch.tensor([cnt.get("slot_gens", 0)])
    if gp.device.type != "cuda":
        raise ValueError(f"unsupported device {gp.device}")
    if len(d_tiers) > 2:
        raise ValueError(f"the kernel holds two slot tiers, got {d_tiers}")
    N = ustart.numel()
    out = torch.empty((7, N), dtype=torch.int32, device=gp.device)
    if N == 0:
        return out, torch.zeros(1, dtype=torch.int64, device=gp.device)
    conf = [W, d_tiers[0], d_tiers[1] if len(d_tiers) > 1 else 0,
            gens_cap(GENS), cut_depth, *sc]
    slot_gens = launch_pool_kernel("gt_greedy_full", gp, desc, conf, out)
    _kernels.record_launch(globals(), int(slot_gens),
                           gp.numel() * 8 + 41 * N + out.numel() * 4)
    return out, slot_gens


def occupancy(W: int, d_tiers) -> dict:
    """The kernel's occupancy on the current card for windows of up to W
    symbols at these slot tiers: resident warps per SM, registers a
    thread, SMs."""
    d_tiers = tuple(d_tiers)
    return kernel_occupancy("gt_greedy_full_occupancy", [
        W, d_tiers[0], d_tiers[1] if len(d_tiers) > 1 else 0, 0, 15, 0, 0,
        0, 0, 64])
