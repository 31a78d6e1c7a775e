"""Sharded suffix sort and bucket histogram over a mesh of devices.

The port of ``genometools_tpu/parallel/dist_esa.py``: the suffix keys
are replicated on every shard's device (the reference's replicated
encseq) and the bucket space is sharded, the concurrent counterpart of
the reference's ``-parts`` code ranges (ref: src/match/sfx-partssuf.c:40):

  1. every shard histograms the first-symbol buckets of its position
     block; ``psum`` gives the global leftborder (ref pass A:
     sfx-suffixer.c updatekmercount);
  2. every shard packs the first ``max_depth`` symbol digits of its
     block into 30-bit words and one block-bitonic network (shared with
     dist_doubling_sharded) sorts the (words..., pos) tuples across the
     mesh (ref pass B + gt_sortallbuckets);
  3. the sorted position blocks are the suffix array's slices.

The order is exact when every repeat diverges within ``max_depth``
symbols; callers check the input's maximal LCP or use the doubling
engines.
"""

from __future__ import annotations

import torch

from .dist_doubling_sharded import _block_bitonic_sort
from .mesh import Mesh, gather, make_mesh, psum

__all__ = ["make_mesh", "sharded_suffix_sort", "sharded_kmer_histogram"]


def _digit(keys: torch.Tensor, pos: torch.Tensor, d: int,
           n1: int) -> torch.Tensor:
    """Symbol key at depth d of each suffix; past the end -> -1."""
    idx = pos + d
    return torch.where(idx < n1, keys[idx.clamp(max=n1 - 1)], -1)


def _pos_blocks(n1: int, mesh: Mesh) -> list:
    ndev = mesh.size
    C = -(-n1 // ndev)
    return [torch.arange(m * C, (m + 1) * C, device=d)
            for m, d in enumerate(mesh.devices)]


def sharded_suffix_sort(keys, n1: int, max_depth: int, mesh: Mesh,
                        sigma: int = 4):
    """Suffix sort of keys[:n1] sharded over the mesh (a power of two).

    Digit encoding (its order is the suffix order): regular code c ->
    c + 1; special (key >= sigma) -> sigma + 1; past the end or after the
    first special -> 0. Two suffixes tying on every packed word share
    their regular prefix and have specials at the same depth, so the
    final pos key finishes the comparison (a special at p has key
    sigma + p). Ties of regular prefixes longer than max_depth are not
    resolved.

    Returns (sa int64[n1], the global first-symbol histogram), on the
    first shard's device."""
    ndev = mesh.size
    assert ndev & (ndev - 1) == 0, "bitonic network needs a pow-2 mesh"
    keys = torch.as_tensor(keys)
    krep = mesh.replicate(keys[:n1].to(torch.int32))
    bits = max(1, (sigma + 1).bit_length())    # codes 0..sigma+1
    per_word = 30 // bits                      # keep words non-negative
    hists, blocks = [], []
    for kr, pos in zip(krep, _pos_blocks(n1, mesh)):
        # pass A: this shard's histogram; all specials share a bucket
        inside = pos < n1
        first = _digit(kr, pos, 0, n1).clamp(max=sigma)
        hists.append(torch.bincount(torch.where(inside, first, sigma),
                                    weights=inside.to(torch.float64),
                                    minlength=sigma + 1).to(torch.int64))
        # pass B: this block's packed digit words
        words, cnt = [], 0
        acc = torch.zeros(pos.shape[0], dtype=torch.int32, device=pos.device)
        alive = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
        for d in range(max_depth):
            idx = pos + d
            dig = kr[idx.clamp(max=n1 - 1)]
            past = idx >= n1
            spec = dig >= sigma
            code = torch.where(past | ~alive, 0,
                               torch.where(spec, sigma + 1, dig + 1))
            acc = (acc << bits) | code
            cnt += 1
            if cnt == per_word:
                words.append(acc)
                acc = torch.zeros_like(acc)
                cnt = 0
            alive &= ~spec & ~past
        if cnt:
            words.append(acc << (bits * (per_word - cnt)))
        # pad positions (pos >= n1) sort last
        words[0] = torch.where(inside, words[0], 2 ** 30)
        blocks.append(words + [pos])
    srt = _block_bitonic_sort(blocks, len(blocks[0]))
    sa = gather([s[-1] for s in srt])[:n1]
    return sa, psum(hists)[0]


def sharded_kmer_histogram(keys, n1: int, mesh: Mesh,
                           num_buckets: int = 5) -> torch.Tensor:
    """Pass A alone: the sharded first-symbol histogram with psum."""
    keys = torch.as_tensor(keys)
    krep = mesh.replicate(keys[:n1].to(torch.int32))
    hists = []
    for kr, pos in zip(krep, _pos_blocks(n1, mesh)):
        inside = pos < n1
        b = _digit(kr, pos, 0, n1).clamp(max=num_buckets - 1)
        hists.append(torch.bincount(
            torch.where(inside, b, num_buckets - 1),
            weights=inside.to(torch.float64),
            minlength=num_buckets).to(torch.int64))
    return psum(hists)[0]
