"""Suffix array + LCP in PyTorch: the packed-bootstrap pipeline and
prefix doubling.

Counterpart of ``genometools_tpu/index/suffix.py``. Two engines give the
same (sa, lcp):

* the packed-bootstrap pipeline (``_sa_pipeline``), the product path,
  for canonical keys (every key >= sigma equals sigma + position, with
  sigma = keys[-1] - (n1 - 1), the contract of ``Encseq.suffix_keys``):
  - the first m symbols of every suffix are packed into two 30-bit
    words (b bits a slot: regular symbol -> code, first special ->
    sigma, after it -> 0; lo's low _FSBITS bits hold the first special's
    offset fs, m when there is none);
  - ONE stable ``torch.sort`` of ``hi << 30 | lo`` ranks every suffix m
    symbols deep. Equal words keep position order, which is the order
    of windows that hold a special (specials compare by position), so
    each such window is a group of its own;
  - only the suffixes still tied (repeats of m symbols or more) are
    refined, by prefix doubling on that subset; each group keeps the
    suftab slot of its first member as its rank (head rank), so a split
    stays inside the group's slots. The still-tied count is read after
    every round and the loop stops at the first round that leaves none;
  - tie groups share their packed words, so the sorted words are valid
    in final suftab order: the lcp of every adjacent pair below m is one
    XOR + leading-zero pass over them, and only pairs with lcp >= m
    descend the rank snapshots of the rounds that did work;
* prefix doubling from _BOOT symbols (``build_sa_impl``, ``lcp_impl``)
  for every other key array (UNDEFCHAR symbols, synthetic keys);
* the wide route, the reference's for inputs past its int32 budget:
  the position-sharded sample-sort engine of
  ``parallel/dist_doubling_sharded`` on int64 lanes, on a one-shard
  mesh of the device, with the LCP by the host's Kasai. It takes
  canonical keys beyond int32 and other keys above 2^30 symbols (pad
  included, as the reference reckons it).

Every special symbol and the sentinel carry a unique key, so no two
suffixes share a full-length rank and the final rank is the inverse
suffix array. The reference's pads (a 1M quantum, powers of two) were
for XLA: here the packed pipeline and doubling work on exactly n1
entries. Storage is int32 (n1 < 2^31); index arithmetic that can pass
2^31 (position + step) is int64.
Full-length passes run in chunks of _CHUNK entries, so that a genome of
2^30 symbols fits the card's memory.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device

_BOOT = 4
_FSBITS = 5                       # fs field: offsets 0..m <= 31
_M30 = (1 << 30) - 1
_CHUNK = 1 << 26                  # entries per pass of a full-length stage
_PAD_QUANTUM = 1 << 20            # the reference's pad, for its routing


# ---------------------------------------------------------------------------
# prefix doubling (non-canonical keys)
# ---------------------------------------------------------------------------

def _dense_rank(sorted_keys: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Dense ranks (cumsum of not-equal flags in sorted order), scattered
    back to positions."""
    neq = torch.ones_like(sorted_keys, dtype=torch.int64)
    neq[0] = 0
    neq[1:] = (sorted_keys[1:] != sorted_keys[:-1]).to(torch.int64)
    r = torch.cumsum(neq, 0)
    return torch.empty_like(r).scatter_(0, order, r)


def _double(rank: torch.Tensor, h: int) -> torch.Tensor:
    """Ranks of 2h-symbol prefixes from ranks of h-symbol prefixes."""
    n1 = rank.shape[0]
    rank2 = torch.full_like(rank, -1)
    if h < n1:
        rank2[:n1 - h] = rank[h:]
    key = (rank << 32) | (rank2 + 1)
    skey, order = torch.sort(key, stable=True)
    return _dense_rank(skey, order)


def build_sa_impl(keys: torch.Tensor, with_rank_levels: bool):
    """(sa, levels): sa int64; levels[t] ranks prefixes of _BOOT*2^t
    symbols (only with with_rank_levels; the last is the final rank)."""
    n1 = keys.shape[0]
    skey, order = torch.sort(keys, stable=True)
    rank = _dense_rank(skey, order)
    h = 1
    while h < _BOOT:
        rank = _double(rank, h)
        h *= 2
    levels = [rank.to(torch.int32)] if with_rank_levels else []
    while int(rank.max()) < n1 - 1:
        rank = _double(rank, h)
        h *= 2
        if with_rank_levels:
            levels.append(rank.to(torch.int32))
    sa = torch.empty_like(rank).scatter_(
        0, rank, torch.arange(n1, device=keys.device))
    return sa, levels


def lcp_impl(keys: torch.Tensor, sa: torch.Tensor, levels) -> torch.Tensor:
    """lcp[i] = lcp(sa[i-1], sa[i]), lcp[0] = 0, by descending the rank
    levels (longest first), then direct key comparisons below _BOOT."""
    n1 = keys.shape[0]
    x = sa[:-1].clone()
    y = sa[1:].clone()
    l = torch.zeros_like(x)
    for t in range(len(levels) - 1, -1, -1):
        step_len = _BOOT << t
        rt = levels[t]
        ok = (x < n1) & (y < n1) & (x != y) & \
            (rt[x.clamp(max=n1 - 1)] == rt[y.clamp(max=n1 - 1)])
        step = torch.where(ok, step_len, 0)
        l += step
        x += step
        y += step
    alive = torch.ones_like(x, dtype=torch.bool)
    for _ in range(_BOOT - 1):
        alive &= (x < n1) & (y < n1) & (x != y) & \
            (keys[x.clamp(max=n1 - 1)] == keys[y.clamp(max=n1 - 1)])
        step = alive.to(torch.int64)
        l += step
        x += step
        y += step
    return torch.cat([torch.zeros(1, dtype=l.dtype, device=l.device), l])


def doubling_sa_lcp(keys: torch.Tensor, with_lcp: bool = True):
    """(sa, lcp) int32 by prefix doubling, for any key array (lcp None
    without with_lcp)."""
    keys = keys.to(torch.int64)
    sa, levels = build_sa_impl(keys, with_lcp)
    lcp = lcp_impl(keys, sa, levels).to(torch.int32) if with_lcp else None
    return sa.to(torch.int32), lcp


# ---------------------------------------------------------------------------
# packed-bootstrap pipeline (canonical keys)
# ---------------------------------------------------------------------------

def _pack_plan(sigma: int):
    """(slot_bits, hi_slots, lo_slots, window_m) for alphabet size
    sigma. lo keeps its bottom _FSBITS bits for the first-special
    offset so (hi, lo) comparison already covers it."""
    b = max(2, int(sigma).bit_length())      # holds 0..sigma (sigma = special)
    per_hi = 30 // b                         # keep int32 sign bit clear
    per_lo = (30 - _FSBITS) // b
    return b, per_hi, per_lo, per_hi + per_lo


def _pack_windows(keysx: torch.Tensor, b: int, per_hi: int, per_lo: int,
                  sigma: int):
    """Pack the m = per_hi+per_lo symbol window at every position into
    (hi, lo) int32 words: b-bit slots (regular -> code, first special ->
    sigma, after first special -> 0), with lo's low _FSBITS bits holding
    fs = offset of the first special (m if none). Lexicographic order of
    (hi, lo) == window order because fs is a function of the slots.
    keysx (int32) carries m entries past the last window's start; only
    whether a key is >= sigma matters there."""
    m = per_hi + per_lo
    n = keysx.shape[0] - m
    hi = torch.zeros(n, dtype=torch.int32, device=keysx.device)
    lo = torch.zeros_like(hi)
    fs = torch.full_like(hi, m)
    seen = torch.zeros(n, dtype=torch.bool, device=keysx.device)
    for j in range(m):
        kj = keysx[j:j + n]
        spec = kj >= sigma
        slot = torch.where(seen, 0, torch.where(spec, sigma, kj))
        fs = torch.where(spec & ~seen, j, fs)
        seen |= spec
        if j < per_hi:
            hi = (hi << b) | slot
        else:
            lo = (lo << b) | slot
    return hi, (lo << _FSBITS) | fs


def _packed_words(keys: torch.Tensor, sigma: int) -> torch.Tensor:
    """int64 words hi << 30 | lo of every suffix's window, packed chunk
    by chunk (the window of the last m positions runs into special
    pads)."""
    b, per_hi, per_lo, m = _pack_plan(sigma)
    n1 = keys.shape[0]
    words = torch.empty(n1, dtype=torch.int64, device=keys.device)
    for a in range(0, n1, _CHUNK):
        e = min(n1, a + _CHUNK)
        win = keys[a:min(n1, e + m)]
        if e + m > n1:
            win = torch.cat([win, torch.full((e + m - n1,), sigma,
                                             dtype=torch.int32,
                                             device=keys.device)])
        hi, lo = _pack_windows(win, b, per_hi, per_lo, sigma)
        torch.bitwise_or(hi.to(torch.int64) << 30, lo, out=words[a:e])
    return words


def _group_heads(starts: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """For every slot, the slot of the last group start at or before it
    (starts[0] is True): the start slots, indexed by the running count of
    starts, chunk by chunk. cumsum and nonzero are device-wide scans;
    torch.cummax on one long row runs in a single thread block (3 ns an
    entry on the H100, PERF.md)."""
    n = starts.shape[0]
    dev = starts.device
    head = torch.empty(n, dtype=dtype, device=dev)
    for a in range(0, n, _CHUNK):
        e = min(n, a + _CHUNK)
        st = starts[a:e]
        # entry 0: the previous chunk's last head, for slots before this
        # chunk's first start (chunk-relative)
        carry = head[a - 1:a].to(torch.int64) - a if a else \
            torch.zeros(1, dtype=torch.int64, device=dev)
        spos = torch.cat([carry, torch.nonzero(st).squeeze(1)])
        head[a:e] = spos[torch.cumsum(st, 0)] + a
    return head


def _bootstrap_rank(words: torch.Tensor, m: int):
    """Sort the packed words stably; return (head ranks by position, the
    tied mask by position, the tied count, the sorted words). Members of
    a tie group share their words, so the sorted words are valid in
    final suftab order."""
    n = words.shape[0]
    swords, order = torch.sort(words, stable=True)
    starts = torch.ones(n, dtype=torch.bool, device=words.device)
    torch.ne(swords[1:], swords[:-1], out=starts[1:])
    starts |= (swords & ((1 << _FSBITS) - 1)) < m    # special windows
    rank = torch.empty(n, dtype=torch.int32, device=words.device)
    rank[order] = _group_heads(starts)
    # tied: in a group of two or more (a singleton is a start followed
    # by a start)
    tied_sorted = torch.ones_like(starts)
    tied_sorted[:-1] = ~(starts[:-1] & starts[1:])
    tied_sorted[-1] = ~starts[-1]
    tied = torch.empty_like(tied_sorted)
    tied[order] = tied_sorted
    del order
    return rank, tied, int(tied_sorted.sum()), swords


def _refine_subset(rank: torch.Tensor, s: torch.Tensor, h: int):
    """One doubling round on the tied positions s (whole groups): sort
    them by (rank[s], rank[s + h]); a group split at slot offset k takes
    rank head + k, so ranks stay inside the group's suftab slots. rank
    (int32) is updated in place; returns the positions still tied."""
    n1 = rank.shape[0]
    s = s.to(torch.int64)
    key1 = rank[s].to(torch.int64)
    key2 = rank[(s + min(h, n1)).clamp_(max=n1 - 1)].to(torch.int64)
    skey, o = torch.sort((key1 << 32) | key2)
    ss = s[o]
    k1 = skey >> 32
    startg = torch.ones_like(k1, dtype=torch.bool)
    startg[1:] = k1[1:] != k1[:-1]
    startp = torch.ones_like(startg)
    startp[1:] = skey[1:] != skey[:-1]
    grp_start = _group_heads(startg, torch.int64)
    pair_start = _group_heads(startp, torch.int64)
    rank[ss] = (k1 + pair_start - grp_start).to(torch.int32)
    startp_next = torch.ones_like(startp)
    startp_next[:-1] = startp[1:]
    return ss[~(startp & startp_next)]


def _lead_slots(d1, d2s, b: int, per_hi: int, per_lo: int):
    """Leading equal slot count from XORed hi words and (fs-stripped)
    lo slot fields, each below 2^30. A word's bit length comes from
    frexp's exponent on float64, which holds every such word exactly."""
    def bitlen(x):
        return torch.frexp(x.to(torch.float64)).exponent.to(torch.int64)
    lead1 = (b * per_hi - bitlen(d1)) // b
    lead2 = (b * per_lo - bitlen(d2s)) // b        # per_lo when d2s == 0
    return torch.where(d1 != 0, lead1, per_hi + lead2)


def _lcp_base(shi, slo, b: int, per_hi: int, per_lo: int):
    """lcp for every adjacent pair of the sorted words with lcp < m,
    elementwise (no gathers); pairs with lcp >= m ("deep") are flagged
    for the level descent, their lcp slot holds m meanwhile. Returns
    (lcp int32 with lcp[0] = 0, deep mask)."""
    m = per_hi + per_lo
    fsmask = (1 << _FSBITS) - 1
    shi = shi.to(torch.int64)
    slo = slo.to(torch.int64)
    d1 = shi[:-1] ^ shi[1:]
    d2s = (slo[:-1] ^ slo[1:]) >> _FSBITS
    lead = _lead_slots(d1, d2s, b, per_hi, per_lo)
    fsx = slo[:-1] & fsmask
    fsy = slo[1:] & fsmask
    res = torch.minimum(lead, torch.minimum(fsx, fsy))
    deep = (d1 == 0) & (d2s == 0) & (fsx == m)
    zero = torch.zeros(1, dtype=torch.int32, device=shi.device)
    return (torch.cat([zero, res.to(torch.int32)]),
            torch.cat([zero.bool(), deep]))


def _lcp_deep(lcp, pidx, sa, levels, swords, m: int, b: int,
              per_hi: int, per_lo: int) -> None:
    """Exact lcp for the deep pairs pidx (lcp-array indices; pair =
    suffixes sa[p-1], sa[p]): descend the rank snapshots (advance m*2^t
    while level-t ranks agree), then one packed-word residue at the
    advanced positions; the word at position q is swords[rank[q]] with
    the final rank levels[-1]. Writes into lcp."""
    n1 = sa.shape[0]
    x = sa[pidx - 1].to(torch.int64)
    y = sa[pidx].to(torch.int64)
    l = torch.zeros_like(x)
    for t in range(len(levels) - 1, -1, -1):
        rt = levels[t]
        ok = (x < n1) & (y < n1) & \
            (rt[x.clamp(max=n1 - 1)] == rt[y.clamp(max=n1 - 1)])
        step = torch.where(ok, m << t, 0)
        l += step
        x += step
        y += step
    final = levels[-1]
    wx = swords[final[x.clamp(max=n1 - 1)].to(torch.int64)]
    wy = swords[final[y.clamp(max=n1 - 1)].to(torch.int64)]
    d = wx ^ wy
    lead = _lead_slots(d >> 30, (d & _M30) >> _FSBITS, b, per_hi, per_lo)
    fsmask = (1 << _FSBITS) - 1
    res = torch.minimum(torch.clamp(lead, max=m),
                        torch.minimum(wx & fsmask, wy & fsmask))
    l += torch.where((x < n1) & (y < n1), res, 0)
    lcp[pidx] = l.to(torch.int32)


def _mark(trace, stage: str, dev: torch.device) -> None:
    """Close a stage: a CUDA event on the card, the host clock on the
    CPU (stage_ms reads them)."""
    if trace is None:
        return
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
    else:
        ev = time.perf_counter()
    trace.setdefault("marks", []).append((stage, ev))


def stage_ms(trace) -> list:
    """[(stage, ms)] between the marks of a traced run (the first mark
    opens the run)."""
    marks = trace["marks"]
    if marks and isinstance(marks[0][1], torch.cuda.Event):
        torch.cuda.synchronize()
        return [(s, a.elapsed_time(b)) for (_, a), (s, b)
                in zip(marks, marks[1:])]
    return [(s, (b - a) * 1e3) for (_, a), (s, b) in zip(marks, marks[1:])]


def _sa_pipeline(keys: torch.Tensor, sigma: int, with_lcp: bool,
                 trace: dict | None = None):
    """(sa, lcp or None), int32, from canonical int32 keys (sentinel
    last). With a trace dict, records the stages' marks, the tied count
    after the bootstrap and after every refinement round ("tied"), and
    the deep pair count ("deep")."""
    dev = keys.device
    n1 = keys.shape[0]
    b, per_hi, per_lo, m = _pack_plan(sigma)
    _mark(trace, "start", dev)
    words = _packed_words(keys, sigma)
    _mark(trace, "pack", dev)
    rank, tied, tc, swords = _bootstrap_rank(words, m)
    del words
    _mark(trace, "bootstrap sort", dev)
    counts = [tc]
    levels = []
    if tc:
        s = torch.nonzero(tied).squeeze(1)
        h = m
        while s.numel():
            if with_lcp:
                levels.append(rank.clone())
            s = _refine_subset(rank, s, h)
            counts.append(int(s.numel()))
            h *= 2
    del tied
    levels.append(rank)
    if trace is not None:
        trace["tied"] = counts
    _mark(trace, "refine", dev)
    sa = torch.empty(n1, dtype=torch.int32, device=dev)
    for a in range(0, n1, _CHUNK):
        e = min(n1, a + _CHUNK)
        sa[rank[a:e].to(torch.int64)] = torch.arange(
            a, e, dtype=torch.int32, device=dev)
    _mark(trace, "sa scatter", dev)
    if not with_lcp:
        return sa, None
    lcp = torch.empty(n1, dtype=torch.int32, device=dev)
    deep = torch.empty(n1, dtype=torch.bool, device=dev)
    for a in range(0, n1, _CHUNK):
        e = min(n1, a + _CHUNK)
        w = swords[max(a - 1, 0):e]
        lc, dp = _lcp_base(w >> 30, w & _M30, b, per_hi, per_lo)
        k = 1 if a else 0
        lcp[a:e] = lc[k:]
        deep[a:e] = dp[k:]
    _mark(trace, "lcp base", dev)
    pidx = torch.nonzero(deep).squeeze(1)
    del deep
    if trace is not None:
        trace["deep"] = int(pidx.numel())
    if pidx.numel():
        _lcp_deep(lcp, pidx, sa, levels, swords, m, b, per_hi, per_lo)
    _mark(trace, "lcp deep", dev)
    return sa, lcp


def _canonical(keys: torch.Tensor, sigma: int) -> bool:
    """Every key >= sigma equals sigma + its position (chunk by chunk)."""
    n1 = keys.shape[0]
    for a in range(0, n1, _CHUNK):
        e = min(n1, a + _CHUNK)
        k = keys[a:e]
        pos = torch.arange(a, e, dtype=torch.int64, device=keys.device)
        if not bool(((k < sigma) | (k == sigma + pos)).all()):
            return False
    return True


def _pad_size(n1: int) -> int:
    """The reference's padded length (powers of two up to 1M, then 1M
    multiples), which its routing reckons with."""
    if n1 <= _PAD_QUANTUM:
        return 1 << max(0, (n1 - 1).bit_length())
    return -(-n1 // _PAD_QUANTUM) * _PAD_QUANTUM


def _build_suffix_array_wide(keys: torch.Tensor, with_lcp: bool,
                             trace: dict | None):
    """The wide route: int64-lane sample-sort doubling on a one-shard
    mesh of keys' device, the LCP by the host's Kasai."""
    from ..core.native import kasai_lcp_native
    from ..parallel.dist_doubling_sharded import sharded_suffix_array
    from ..parallel.mesh import Mesh
    dev = keys.device
    t0 = time.perf_counter()
    sa = sharded_suffix_array(keys, Mesh([dev]), lanes="int64")
    sa = sa.astype(np.int32)
    if trace is not None:
        trace["sort_s"] = time.perf_counter() - t0
    lcp = None
    if with_lcp:
        t0 = time.perf_counter()
        hk = keys.cpu().numpy()
        if int(hk.max()) >= 2 ** 31 or int(hk.min()) < -2 ** 31:
            # equal keys stay equal under an order-preserving renaming
            hk = np.unique(hk, return_inverse=True)[1]
        lcp = kasai_lcp_native(hk, sa)
        if lcp is None:
            lcp = kasai_lcp(hk, sa)
        if trace is not None:
            trace["kasai_s"] = time.perf_counter() - t0
        lcp = torch.from_numpy(lcp).to(dev)
    return torch.from_numpy(sa).to(dev), lcp


def build_suffix_array(keys, with_lcp: bool = True, device="cuda",
                       trace: dict | None = None, engine: str = "auto"):
    """(sa, lcp) as int32 tensors on `device` from suffix keys of length
    totallength+1 (sentinel included): sa is the full suftab, lcp[i] =
    lcp(sa[i-1], sa[i]) with lcp[0] = 0 (None without with_lcp).

    keys is a numpy array or a tensor (one already on `device` is not
    copied). Canonical keys (every key >= sigma equals sigma + position,
    sigma = keys[-1] - (n1 - 1), 1 <= sigma < 2^24) take the packed
    pipeline unless their values pass int32, every other key array
    prefix doubling unless it passes the reference's int32 budget (more
    than 2^30 symbols, or keys reaching 2^31 - 1 with its pad);
    engine="wide" forces the wide route (module docstring) for any
    input. trace (a dict) gets the engine taken, and is filled by the
    pipeline (see _sa_pipeline) or the wide route (its sort and Kasai
    seconds)."""
    if engine not in ("auto", "wide"):
        raise ValueError(f"unknown engine {engine!r}")
    dev = resolve_device(device)
    if not isinstance(keys, torch.Tensor):
        keys = torch.from_numpy(np.ascontiguousarray(keys))
    keys = keys.to(dev)
    n1 = int(keys.shape[0])
    if n1 == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z, (z if with_lcp else None)
    if n1 >= 2 ** 31:
        # the reference's wide route casts its SA to int32, which wraps
        # positions from 2^31 on: the port stops here instead
        raise NotImplementedError("inputs of 2^31 symbols or more are not "
                                  "ported yet")
    sigma = int(keys[-1]) - (n1 - 1)
    if engine == "auto":
        if 1 <= sigma < 2 ** 24 and _canonical(keys, sigma):
            engine = "packed" if sigma + n1 <= 2 ** 31 - 1 else "wide"
        else:
            npad = _pad_size(n1)
            engine = "wide" if npad > 2 ** 30 or \
                int(keys.max()) + (npad - n1) >= 2 ** 31 - 1 else "doubling"
    if trace is not None:
        trace["engine"] = engine
    if engine == "packed":
        return _sa_pipeline(keys.to(torch.int32), sigma, with_lcp, trace)
    if engine == "wide":
        return _build_suffix_array_wide(keys, with_lcp, trace)
    return doubling_sa_lcp(keys, with_lcp)


def check_sa_lcp(keys: torch.Tensor, sa: torch.Tensor,
                 lcp: torch.Tensor, direct: int = 64) -> bool:
    """Certificate of (sa, lcp) on the device, independent of both
    engines (the device counterpart of check_suftab_order): sa is a
    permutation, lcp[0] = 0, and for every adjacent pair (x, y) =
    (sa[i-1], sa[i]) with l = lcp[i] the first l keys of x and y agree
    and keys[x+l] < keys[y+l]. That proves the order and every lcp
    exactly. Pairs with l < direct compare column by column over the
    whole chunk; longer ones as a compacted set afterwards."""
    n1 = keys.shape[0]
    if sa.shape[0] != n1 or lcp.shape[0] != n1:
        return False
    if n1 == 0:
        return True
    if not bool((torch.bincount(sa.to(torch.int64), minlength=n1)
                 == 1).all()) or int(sa.min()) < 0 or int(lcp[0]) != 0:
        return False
    long_pairs = []
    for a in range(1, n1, _CHUNK):
        e = min(n1, a + _CHUNK)
        x = sa[a - 1:e - 1].to(torch.int64)
        y = sa[a:e].to(torch.int64)
        l = lcp[a:e].to(torch.int64)
        if bool(((l < 0) | (x + l >= n1) | (y + l >= n1)).any()):
            return False
        if not bool((keys[x + l] < keys[y + l]).all()):
            return False
        for j in range(min(direct, int(l.max()))):
            live = l > j
            if not bool((~live | (keys[(x + j).clamp_(max=n1 - 1)] ==
                                  keys[(y + j).clamp_(max=n1 - 1)])).all()):
                return False
        far = torch.nonzero(l > direct).squeeze(1)
        if far.numel():
            long_pairs.append((x[far], y[far], l[far]))
    cols = torch.arange(direct, device=keys.device)
    for x, y, l in long_pairs:
        # blocks of `direct` columns over 2^20 pairs at a time
        for r in range(0, x.numel(), 1 << 20):
            xr, yr, lr = x[r:r + (1 << 20)], y[r:r + (1 << 20)], \
                l[r:r + (1 << 20)]
            j = direct
            while xr.numel():
                c = j + cols
                px = (xr[:, None] + c).clamp_(max=n1 - 1)
                py = (yr[:, None] + c).clamp_(max=n1 - 1)
                if not bool(((c >= lr[:, None]) |
                             (keys[px] == keys[py])).all()):
                    return False
                more = lr > j + direct
                xr, yr, lr = xr[more], yr[more], lr[more]
                j += direct
    return True


# ---------------------------------------------------------------------------
# host-side reference implementations (cross-checks, mirror of the
# reference's internal verifiers sfx-lwcheck.c / sfx-suftaborder.c)
# ---------------------------------------------------------------------------

def suffix_array_bruteforce(keys: np.ndarray) -> np.ndarray:
    """O(n^2 log n) reference: sort suffixes of the key array directly."""
    keys = np.asarray(keys)
    n1 = keys.size
    idx = sorted(range(n1), key=lambda i: keys[i:].tolist())
    return np.asarray(idx, np.int32)


def lcp_bruteforce(keys: np.ndarray, sa: np.ndarray) -> np.ndarray:
    keys = np.asarray(keys)
    out = np.zeros(len(sa), np.int32)
    for i in range(1, len(sa)):
        a, b = sa[i - 1], sa[i]
        l = 0
        while a + l < keys.size and b + l < keys.size and keys[a + l] == keys[b + l]:
            l += 1
        out[i] = l
    return out


def kasai_lcp(keys: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Kasai 13n LCP (ref: gt_ENCSEQ_lcp13_kasai, src/match/sfx-linlcp.c:31).

    Host-side numpy/Python; used as a cross-check for the device LCP.
    """
    keys = np.asarray(keys)
    n1 = len(sa)
    rank = np.empty(n1, np.int64)
    rank[sa] = np.arange(n1)
    lcp = np.zeros(n1, np.int32)
    h = 0
    for i in range(n1):
        r = rank[i]
        if r > 0:
            j = sa[r - 1]
            while i + h < n1 and j + h < n1 and keys[i + h] == keys[j + h]:
                h += 1
            lcp[r] = h
            if h > 0:
                h -= 1
        else:
            h = 0
    return lcp


def check_suftab_order(keys: np.ndarray, sa: np.ndarray) -> bool:
    """Lightweight order check (ref: gt_suftab_lightweightcheck,
    src/match/sfx-lwcheck.c): verify adjacent suffixes strictly increase."""
    keys = np.asarray(keys)
    n1 = keys.size
    if sorted(sa.tolist()) != list(range(n1)):
        return False
    for i in range(1, n1):
        a, b = int(sa[i - 1]), int(sa[i])
        # compare suffixes
        la, lb = n1 - a, n1 - b
        m = min(la, lb)
        ka, kb = keys[a:a + m], keys[b:b + m]
        d = np.nonzero(ka != kb)[0]
        if d.size == 0:
            if la >= lb:
                return False
        else:
            j = d[0]
            if ka[j] > kb[j]:
                return False
    return True
