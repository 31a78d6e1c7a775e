"""Maximal pairs with the suffix-rank axis cut over the lanes of a mesh.

The port of ``genometools_tpu/parallel/dist_maxpairs.py``, the
counterpart of the reference's threaded ESA traversal (thread model
sfx-suffixer.c:2098 parts; walker esa-maxpairs.c:477): the rank axis is
cut where lcp < searchlength. No lcp-interval of depth >= searchlength
crosses such a cut, so the ranges' interval trees are independent and
their walks need no communication; each lane (a host thread) walks its
range with the native bottom-up stack engine, and the concatenation in
rank order is the sequential walker's emission order.
"""

from __future__ import annotations

import threading

import numpy as np

from .mesh import Mesh, make_mesh


def lcp_cut_ranges(lcp_small: np.ndarray, searchlength: int,
                   parts: int) -> list[tuple[int, int]]:
    """<= parts contiguous rank ranges cut only where lcp < searchlength
    (capped bytes suffice for searchlength <= 255)."""
    n1 = lcp_small.size
    cuts = [0]
    for t in range(1, max(parts, 1)):
        r = n1 * t // parts
        while r < n1 and lcp_small[r] >= min(searchlength, 255):
            r += 1
        if cuts[-1] < r < n1:
            cuts.append(r)
    cuts.append(n1)
    return [(cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1)
            if cuts[i] < cuts[i + 1]]


def distributed_maxpairs(esa, searchlength: int, devices=None,
                         device="cuda"):
    """Maximal pairs >= searchlength with the rank axis cut over one
    lane per device of the mesh (devices: a Mesh or a list; by default
    every card of `device`'s kind). Returns a MaxPairs equal to
    enumerate_maxpairs(esa, searchlength) row for row."""
    from ..core.native import maxpairs_native
    from ..match.maxpairs import MaxPairs, left_context_classes
    if devices is None:
        devices = make_mesh(device=device)
    if isinstance(devices, Mesh):
        devices = devices.devices
    cls = left_context_classes(esa)
    sigma = esa.encseq.alphabet.num_chars
    sa, lcp = esa.suftab, esa.lcptab
    small = np.minimum(lcp, 255).astype(np.uint8)
    ranges = lcp_cut_ranges(small, searchlength, max(len(devices), 1))
    results: list = [None] * len(ranges)
    errors = []

    def work(i, lo, hi):
        try:
            res = maxpairs_native(sa[lo:hi], lcp[lo:hi], cls[lo:hi],
                                  searchlength, sigma)
            if res is None:
                raise RuntimeError("the native maximal-pairs walk is "
                                   "unavailable")
            results[i] = res
        except BaseException as e:      # raised again below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i, lo, hi))
               for i, (lo, hi) in enumerate(ranges)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    if not results:
        z = np.zeros(0, np.int32)
        return MaxPairs(z, z, z)
    return MaxPairs(*(np.concatenate([r[i] for r in results])
                      for i in range(3)))
