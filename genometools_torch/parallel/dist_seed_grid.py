"""The seed_extend part x part grid over a mesh of devices.

The port of ``genometools_tpu/parallel/dist_seed_grid.py``: the
distribution axis the reference reaches with threads over part pairs
(ref: src/match/diagbandseed.c:5982/6044, src/tools/gt_seed_extend.c:1251).

``grid_mlistlen`` counts each grid cell's merged seed-pair list length
(the reference's mlistlen, gt_diagbandseed_get_mlistlen) with the cells
sharded over the mesh: every shard holds the k-mer lists, one sorted
b-list per B-range, and counts its cells with two ``searchsorted`` a
cell over the range-masked a-list.

``distributed_seed_extend`` is the full dispatch: cells are balanced by
those counts, largest first onto the least loaded lane, one lane (a
thread) per device of the mesh, and every lane runs its cells' whole
pipeline (pairing, diagonal bands, the extension rounds through K1, K2r
and K3, match records) on its own device, on a stream of its own. The
output is reassembled in grid-cell order, so it is the single-device
grid's line for line (the reference's thread-count invariance).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import _kernels
from ..device import resolve_device
from .mesh import Mesh, make_mesh


def _grid_counts(acode, aseq, bcode_by_range, cells: np.ndarray,
                 mesh: Mesh) -> np.ndarray:
    """Seed-pair counts of the cells (rows (alo, ahi, b-range)), the
    cells dealt over the mesh in contiguous blocks."""
    nP = mesh.size
    per = -(-len(cells) // nP)
    out = []
    for m, dev in enumerate(mesh.devices):
        blk = cells[m * per:(m + 1) * per]
        if not len(blk):
            continue
        ac, aq = acode.to(dev), aseq.to(dev)
        bmat = bcode_by_range.to(dev)
        counts = []
        for alo, ahi, bri in blk.tolist():
            bc = bmat[bri]
            hit = torch.searchsorted(bc, ac, right=True) - \
                torch.searchsorted(bc, ac)
            counts.append(torch.where((aq >= alo) & (aq <= ahi), hit,
                                      0).sum())
        out.append(torch.stack(counts).cpu())
    return torch.cat(out).numpy().astype(np.int64)


def grid_mlistlen(alist, blists_by_range, aranges, mesh: Mesh,
                  selfcomp: bool = True) -> np.ndarray:
    """Seed-pair counts of every grid cell, the cells sharded over the
    mesh. alist: (code, seq, pos) k-mer list of A; blists_by_range: one
    (code, seq, pos) list per B sequence range; aranges: [(lo, hi)] A
    sequence ranges. Returns int64[ncells] in (a-major, b-minor) order,
    b >= a for a self-comparison."""
    # codes renamed to dense ids in their order (codes of k = 32 fill
    # 64 bits); a sentinel above every id pads the shorter b-lists
    union = np.unique(np.concatenate(
        [np.asarray(alist[0])] + [np.asarray(b[0])
                                  for b in blists_by_range]))
    acode = torch.from_numpy(np.searchsorted(union, alist[0]))
    aseq = torch.from_numpy(np.asarray(alist[1], np.int64))
    nb = len(blists_by_range)
    maxlen = max(1, max(np.asarray(b[0]).size for b in blists_by_range))
    bmat = torch.full((nb, maxlen), union.size + 1, dtype=torch.int64)
    for i, b in enumerate(blists_by_range):
        c = np.sort(np.searchsorted(union, b[0]))
        bmat[i, :c.size] = torch.from_numpy(c)
    cells = np.asarray([(alo, ahi, bi)
                        for ai, (alo, ahi) in enumerate(aranges)
                        for bi in range(ai if selfcomp else 0, nb)],
                       np.int64).reshape(-1, 3)
    return _grid_counts(acode, aseq, bmat, cells, mesh)


def distributed_seed_extend(aenc, benc, params, events=None, devices=None,
                            device="cuda"):
    """The part x part seed_extend grid with its cells on the lanes of a
    mesh (module docstring). Same contract as match.seed_extend's
    seed_extend with params.parts > 1; devices (a Mesh or a list of
    devices, repeats allowed) defaults to every card of `device`'s kind.
    Returns the matches in grid-cell order."""
    from ..match.seed_extend import (_filter_list, enumerate_kmers,
                                     grid_cell_matches, grid_cells,
                                     run_context, _revcomp_codes)
    if devices is None:
        devices = make_mesh(device=device)
    if isinstance(devices, Mesh):
        devices = devices.devices
    devices = [resolve_device(d) for d in devices]
    selfcomp = benc is None
    benc_eff = benc or aenc
    strands, base = run_context(aenc, benc_eff, params, None, None)
    aranges, branges, cells = grid_cells(aenc, benc_eff, selfcomp, params)
    if not cells:
        return []
    k = base["k"]
    alist_full = enumerate_kmers(aenc, k, revcomp=False)
    blists = {d: enumerate_kmers(benc_eff, k, revcomp=(d == "P"))
              for d in strands}
    if "P" in strands:
        _revcomp_codes(benc_eff)        # cached once, before the lanes

    # device-counted workloads drive the lane assignment (the stage the
    # reference sizes thread parts with, gt_diagbandseed_get_mlistlen)
    nlanes = max(1, min(len(devices), len(cells)))
    cmap = {c: 1 for c in cells}
    if nlanes > 1 and strands:
        counts = grid_mlistlen(
            alist_full, [_filter_list(blists[strands[0]], lo, hi)
                         for lo, hi in branges],
            aranges, Mesh(devices[:nlanes]), selfcomp=selfcomp)
        full = [(ai, bi) for ai in range(len(aranges))
                for bi in range(ai if selfcomp else 0, len(branges))]
        cmap = {c: int(n) for c, n in zip(full, counts)}

    # largest first onto the least loaded lane
    lanes = [[] for _ in range(nlanes)]
    loads = [0] * nlanes
    for idx in sorted(range(len(cells)), key=lambda i: -cmap[cells[i]]):
        lane = loads.index(min(loads))
        lanes[lane].append(idx)
        loads[lane] += cmap[cells[idx]]

    results = [None] * len(cells)
    cell_events = [[] if events is not None else None for _ in cells]
    errors = []

    def run_lane(lane_id):
        dev = devices[lane_id]
        try:
            with _kernels.lane(lane_id, dev):
                pools = {}            # the lane's strand pools, on dev
                for idx in lanes[lane_id]:
                    ai, bi = cells[idx]
                    run = dict(base, dev=dev, events=cell_events[idx],
                               pools=pools)
                    results[idx] = grid_cell_matches(
                        aenc, benc_eff, selfcomp, strands, alist_full,
                        blists, aranges[ai], branges[bi], ai == bi, run)
        except BaseException as e:      # raised again below
            errors.append(e)

    threads = [threading.Thread(target=run_lane, args=(i,))
               for i in range(nlanes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    out = []
    for idx in range(len(cells)):
        out.extend(results[idx])
        if events is not None:
            events.extend(cell_events[idx])
    return out
