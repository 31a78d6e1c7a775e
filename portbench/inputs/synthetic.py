"""Synthetic genomes for the benchmark's traffic.

Frozen here so that the yardstick does not move with the program:
``mutate`` is copied verbatim from ``genometools_torch/utils/synthetic.py``
at commit f3ca459de4d5; ``ltr_genome`` follows that file's
``planted_transposons`` (family consensus sequences, diverged copies,
target-site duplications, runs of ``n``) and ``bacterial_genome`` its
``planted_repeats`` (segment copies anywhere, half of them
reverse-complemented, diverged). Where they differ from the originals,
their docstrings say so.
"""

from __future__ import annotations

import numpy as np

ACGT = np.frombuffer(b"acgt", np.uint8)


def mutate(rng, codes, sub, indel=0.005):
    """codes with a `sub` share of substitutions and an `indel` share of
    1-3 bp insertions and deletions."""
    v = codes.copy()
    n = int(sub * v.size)
    pos = rng.integers(0, v.size, n)
    v[pos] = (v[pos] + rng.integers(1, 4, n)) % 4
    out, i = [], 0
    for p in np.sort(rng.integers(0, v.size, int(indel * v.size))):
        if p < i:
            continue
        out.append(v[i:p])
        i = int(p)
        if rng.random() < 0.5:
            out.append(rng.integers(0, 4, rng.integers(1, 4)).astype(np.uint8))
        else:
            i += int(rng.integers(1, 4))
    out.append(v[i:])
    return np.concatenate(out)


def random_codes(rng, n: int, gc: float = 0.5) -> np.ndarray:
    """n codes 0-3 (a, c, g, t) with a `gc` share of c and g."""
    u = rng.random(n, dtype=np.float32)
    at, cg = (1.0 - gc) / 2, gc / 2
    return ((u >= at).astype(np.uint8) + (u >= at + cg) +
            (u >= at + 2 * cg)).astype(np.uint8)


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)


def ltr_genome(shape_rng, rng, length: int, te_share: float, families: int,
               element_len: tuple[int, int], ltr_len: tuple[int, int],
               divergence: tuple[float, float], indel: float,
               tsd: int, wildcard_runs: int, wildcard_len: int) -> bytes:
    """One chromosome of `length` bp whose `te_share` is LTR
    retrotransposons, as lower-case acgt/n bytes.

    Each of `families` families has a consensus element: an LTR of
    `ltr_len` bp, internal sequence (shared by the family, unlike
    planted_transposons, whose elements each draw their own), the same
    LTR again; the whole element is `element_len` bp. A copy is the
    consensus mutated by a uniform `divergence` share of substitutions
    and an `indel` share of indels, with a `tsd` bp target-site
    duplication. Copies are inserted one after another at uniform
    positions of the growing sequence, so a later copy may land inside
    an earlier one (nesting, which planted_transposons does not do),
    starting from uniform random background. Then `wildcard_runs` runs
    of `wildcard_len` ``n`` at uniform positions.

    shape_rng draws the elements: each family's consensus and each
    copy of it, mutations included, so every run holds the same set of
    copies. rng draws the background, the order and places in which
    the copies are inserted, and the runs of ``n``."""
    els = shape_rng.integers(element_len[0], element_len[1] + 1, families)
    lts = shape_rng.integers(ltr_len[0], ltr_len[1] + 1, families)
    picks, total = [], 0
    while total < te_share * length:
        f = int(shape_rng.integers(0, families))
        picks.append((f, float(shape_rng.uniform(*divergence))))
        total += int(els[f]) + tsd
    cons = []
    for el, lt in zip(els.tolist(), lts.tolist()):
        ltr = shape_rng.integers(0, 4, lt).astype(np.uint8)
        inner = shape_rng.integers(0, 4, max(el - 2 * lt, 0)).astype(np.uint8)
        cons.append(np.concatenate([ltr, inner, ltr]))
    copies = [np.concatenate([mutate(shape_rng, cons[f], d, indel),
                              shape_rng.integers(0, 4, tsd).astype(np.uint8)])
              for f, d in picks]
    copies = [copies[i] for i in rng.permutation(len(copies))]
    total = sum(c.size for c in copies)
    pieces = [random_codes(rng, max(length - total, 1))]
    # insert each copy at a uniform position of the sequence so far:
    # split the piece holding it (the sequence is a list of pieces)
    lens = np.array([pieces[0].size], np.int64)
    for c in copies:
        cum = np.cumsum(lens)
        p = int(rng.integers(0, int(cum[-1]) + 1))
        k = int(np.searchsorted(cum, p, side="left"))
        if k == len(pieces):
            pieces.append(c)
            lens = np.append(lens, c.size)
            continue
        off = p - (int(cum[k]) - int(lens[k]))
        left, right = pieces[k][:off], pieces[k][off:]
        pieces[k:k + 1] = [left, c, right]
        lens = np.concatenate([lens[:k], [left.size, c.size, right.size],
                               lens[k + 1:]])
    seq = np.concatenate(pieces)[:length]
    text = ACGT[seq]
    for p in rng.integers(0, length - wildcard_len, wildcard_runs):
        text[p:p + wildcard_len] = ord("n")
    return text.tobytes()


def repeat_copies(shape_rng, gc: float, repeats: list[tuple[int, int]],
                  divergence: tuple[float, float]) -> list[np.ndarray]:
    """bacterial_genome's repeat copies, as codes: per (segment length,
    copies) a random segment, each copy of it with a uniform
    `divergence` share of substitutions, half reverse-complemented."""
    copies = []
    for seglen, n in repeats:
        seg = random_codes(shape_rng, seglen, gc)
        for _ in range(n):
            c = mutate(shape_rng, seg, shape_rng.uniform(*divergence), 0)
            copies.append(revcomp(c) if shape_rng.random() < 0.5 else c)
    return copies


def bacterial_genome(shape_rng, rng, length: int, gc: float,
                     plasmids: list[int], repeats: list[tuple[int, int]],
                     divergence: tuple[float, float]) -> list[bytes]:
    """A chromosome of `length` bp and plasmids of the given lengths,
    uniform random with a `gc` share of c and g, as lower-case acgt
    bytes. Into the chromosome go repeat families (rRNA operons, IS
    elements), one per (segment length, copies) of `repeats`: a random
    segment copied over, each copy at a uniform position, half of them
    reverse-complemented, with a uniform `divergence` share of
    substitutions and no indels (planted_repeats takes its segments
    from the genome and adds indels).

    shape_rng draws the copies: each segment and each copy of it,
    mutations and strand included, so every run holds the same set of
    copies (and the suffix engine refines their ties as deep). rng
    draws the chromosome's and the plasmids' sequence, and the order
    and places of the copies, which never overlap (so none cuts
    another's tie short)."""
    copies = repeat_copies(shape_rng, gc, repeats, divergence)
    # uniform places that never overlap: sorted draws over the length
    # the copies leave free, each shifted past the copies before it
    chrom = random_codes(rng, length, gc)
    order = rng.permutation(len(copies))
    free = length - sum(c.size for c in copies)
    shift = 0
    for p, k in zip(np.sort(rng.integers(0, free + 1, len(copies))), order):
        c = copies[k]
        chrom[p + shift:p + shift + c.size] = c
        shift += c.size
    return [ACGT[chrom].tobytes()] + \
        [ACGT[random_codes(rng, n, gc)].tobytes() for n in plasmids]


def write_fasta(path, records: list[tuple[str, bytes]], width: int = 70):
    """FASTA with `width`-column lines."""
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name.encode() + b"\n")
            s = np.frombuffer(seq, np.uint8)
            m = s.size - s.size % width
            body = np.empty((m // width, width + 1), np.uint8)
            body[:, :width] = s[:m].reshape(-1, width)
            body[:, width] = 10
            f.write(body.tobytes())
            if s.size > m:
                f.write(s[m:].tobytes() + b"\n")
