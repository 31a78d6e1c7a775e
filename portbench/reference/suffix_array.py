"""Plain reference of suffixerator's tables: the suffix array and the
LCP table of a key array (see fasta.suffix_keys), by prefix doubling
in plain torch operations, then the LCP of each adjacent pair by
binary lifting over the ranks every doubling round left.

Imports numpy and torch alone. Runs on any torch device; on the card
it takes some 60 bytes a key at its peak.
"""

from __future__ import annotations

import numpy as np
import torch


def sa_lcp(keys: np.ndarray, device="cpu", depth_log2: int | None = None):
    """(suftab, lcptab) as int64 numpy arrays: suftab lists the suffixes
    of `keys` in lexicographic order, lcptab[i] is the length of the
    longest common prefix of suffixes suftab[i - 1] and suftab[i]
    (lcptab[0] = 0).

    depth_log2 stops the doubling once ranks cover 2**depth_log2 keys,
    leaving longer ties in position order: the control, a sort that
    does not look past that depth."""
    x = torch.from_numpy(np.ascontiguousarray(keys, np.int64)).to(device)
    n = x.numel()
    rank = torch.unique(x, sorted=True, return_inverse=True)[1]
    levels = [rank.to(torch.int32)]        # levels[t]: rank by 2**t keys
    h, nxt = 1, None
    while int(rank.max()) + 1 < n and (depth_log2 is None or
                                       h < (1 << depth_log2)):
        nxt = torch.zeros_like(rank)
        nxt[:n - h] = rank[h:] + 1          # 0: past the end
        rank = torch.unique(rank * (n + 1) + nxt, sorted=True,
                            return_inverse=True)[1]
        levels.append(rank.to(torch.int32))
        h *= 2
    del nxt, x
    sa = torch.sort(rank, stable=True).indices
    del rank
    a, b = sa[:-1], sa[1:]
    lcp = torch.zeros(n - 1, dtype=torch.int64, device=sa.device)
    for t in range(len(levels) - 1, -1, -1):
        ia, ib = a + lcp, b + lcp
        ok = (ia < n) & (ib < n)
        lv = levels[t]
        eq = ok & (lv[ia.clamp(max=n - 1)] == lv[ib.clamp(max=n - 1)])
        lcp += eq.to(torch.int64) << t
    lcp = torch.cat([lcp.new_zeros(1), lcp])
    return sa.cpu().numpy(), lcp.cpu().numpy()
