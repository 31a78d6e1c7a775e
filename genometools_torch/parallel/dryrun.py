"""One pass over every part of the multi-device layer on a small input.

The port's counterpart of the repository root's ``__graft_entry__.py``
``dryrun_multichip``: on a mesh of n_devices shards (dealt over the
attached cards, several to a card where there are fewer; on the CPU all
on it) it runs the sharded histogram and suffix sort, both distributed
doublings (at1MB's 772,378 suffixes for the position-sharded engine),
the grid counts and the distributed extension, the int64 lanes, the
sharded build_esa, tallymer's counts and the maximal pairs, each against
its single-device route, and prints one summary line. Any disagreement
raises AssertionError.
"""

from __future__ import annotations

import tempfile
from collections import Counter
from pathlib import Path

import numpy as np
import torch

AT1MB = Path(__file__).resolve().parents[2] / "tests" / "golden_esa" / \
    "at1MB" / "idx"


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """Run the layer once on n_devices shards of `device`'s kind; returns
    (and prints) the summary line."""
    from ..core.encseq import Encseq
    from ..index.esa import build_esa, write_esa
    from ..index.suffix import build_suffix_array
    from ..match.maxpairs import enumerate_maxpairs
    from ..match.seed_extend import (SeedExtendParams, enumerate_kmers,
                                     seed_extend, sequence_ranges)
    from ..ops.kmer import kmer_codes_np
    from .dist_doubling import distributed_build_sa
    from .dist_doubling_sharded import sharded_suffix_array
    from .dist_esa import sharded_kmer_histogram, sharded_suffix_sort
    from .dist_maxpairs import distributed_maxpairs
    from .dist_seed_grid import distributed_seed_extend, grid_mlistlen
    from .dist_tallymer import sharded_mer_counts
    from .mesh import virtual_mesh

    mesh = virtual_mesh(n_devices, device)
    dev = mesh.devices[0]

    def single_sa(k):
        return build_suffix_array(k, with_lcp=False,
                                  device=dev)[0].cpu().numpy()

    rng = np.random.default_rng(1)
    seq = "".join(rng.choice(list("acgtn"), 253, p=[0.24] * 4 + [0.04]))
    e = Encseq.from_string(seq)
    keys = e.suffix_keys()
    n1 = keys.size

    hist = sharded_kmer_histogram(keys, n1, mesh)
    assert int(hist.sum()) == n1, "pass-A histogram wrong"
    sa, _ = sharded_suffix_sort(keys, n1, 32, mesh)
    sa = sa.cpu().numpy()
    assert sorted(sa.tolist()) == list(range(n1)), "not a permutation"
    assert sa.tolist() == single_sa(keys).tolist(), \
        "sharded sort disagrees with the single-device engine"

    # replicated-rank distributed doubling (all_to_all + psum)
    npad = -(-n1 // n_devices) * n_devices
    keys_p = np.concatenate([keys, keys.max() + 1 + np.arange(
        npad - n1, dtype=np.int32)])
    sa2 = distributed_build_sa(keys_p, npad, mesh).cpu().numpy()
    assert sa2[:n1].tolist() == single_sa(keys_p)[:n1].tolist(), \
        "distributed doubling disagrees with the single-device engine"

    # position-sharded doubling at at1MB's size
    big = Encseq.load(str(AT1MB)).suffix_keys()
    sa3 = sharded_suffix_array(big, mesh)
    assert sa3.tolist() == single_sa(big).tolist(), \
        "position-sharded doubling disagrees at at1MB"

    # the grid's per-cell seed counts against a host count
    ge = Encseq.from_string("|".join(
        "".join(np.random.default_rng(3 + i).choice(list("acgt"), 120))
        for i in range(6)))
    alist = enumerate_kmers(ge, 6, revcomp=False)
    aranges = sequence_ranges(ge, 3)
    blists = []
    for lo, hi in aranges:
        m = (alist[1] >= lo) & (alist[1] <= hi)
        blists.append((alist[0][m], alist[1][m], alist[2][m]))
    got = grid_mlistlen(alist, blists, aranges, mesh, selfcomp=True)
    want = []
    for ai, (alo, ahi) in enumerate(aranges):
        for bi in range(ai, len(aranges)):
            cb = Counter(blists[bi][0].tolist())
            am = (alist[1] >= alo) & (alist[1] <= ahi)
            want.append(sum(cb[c] for c in alist[0][am].tolist()))
    assert got.tolist() == want, "sharded grid seed counts wrong"

    # the grid's cells on the mesh's lanes: the single-device lines
    sp = SeedExtendParams(userdefinedleastlength=10, minidentity=80,
                          sensitivity=97, extension="greedy", parts=3)
    want_m = [m.line() for m in seed_extend(ge, None, sp, device=dev)]
    got_m = [m.line() for m in distributed_seed_extend(
        ge, None, sp, devices=mesh)]
    assert got_m == want_m, "distributed seed_extend lines differ"

    # int64 lanes: a constant offset keeps every suffix comparison
    wide = big[:1 << 15].astype(np.int64) + (np.int64(7) << np.int64(32))
    sa4 = sharded_suffix_array(wide, mesh)
    assert sa4.tolist() == single_sa(big[:1 << 15]).tolist(), \
        "int64-lane sharded doubling disagrees"

    # build_esa on the mesh writes the single-device files
    with tempfile.TemporaryDirectory() as td:
        write_esa(build_esa(e, mesh=mesh, device=dev), f"{td}/dist")
        write_esa(build_esa(e, device=dev), f"{td}/single")
        for ext in (".suf", ".lcp", ".llv"):
            assert Path(f"{td}/dist{ext}").read_bytes() == \
                Path(f"{td}/single{ext}").read_bytes(), \
                f"sharded build_esa {ext} differs"

    # tallymer's counts: all_to_all code-range routing
    code9, valid9 = kmer_codes_np(e.codes, 9)
    code9 = code9[valid9]
    dm, dc = sharded_mer_counts(code9, 9, mesh)
    wm, wc = np.unique(code9, return_counts=True)
    assert (dm == wm).all() and (dc == wc).all(), \
        "sharded tallymer counts differ"

    # maximal pairs with the rank axis cut over the lanes
    esa_mp = build_esa(e, device=dev)
    mp_d = distributed_maxpairs(esa_mp, 3, devices=mesh)
    mp_s = enumerate_maxpairs(esa_mp, 3)
    assert all(np.array_equal(getattr(mp_d, f), getattr(mp_s, f))
               for f in ("pos1", "pos2", "length")), \
        "distributed maxpairs differ"

    line = (f"dryrun_multichip OK on {n_devices} shards of "
            f"{sorted({str(d) for d in mesh.devices})}: n1={n1}, "
            f"hist={hist.tolist()}, distributed doubling exact, "
            f"position-sharded doubling exact at n={big.size}, "
            f"seed grid sharded over {len(want)} cells exact, "
            f"distributed extension dispatch exact ({len(want_m)} "
            f"matches), int64 lanes exact, sharded tallymer counts exact "
            f"({dm.size} mers), distributed maxpairs exact "
            f"({mp_s.count} pairs)")
    print(line)
    return line
