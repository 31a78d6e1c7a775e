"""Synthetic genomes with planted repeats, for the long-flank path.

``planted_repeats`` builds the ``g4m_planted_repeats`` input of
chip_smoke.py (two 2,000,000 bp sequences, 150 repeats of
1,000-20,000 bp, numpy seed 2026) and the scaled-down copies the CPU
tests use: uniform random ACGT, then repeat copies of source segments
placed anywhere in either sequence, half of them reverse-complemented,
each with 1-10 % substitutions and 0.5 % indels of 1-3 bp, then runs of
100 ``n`` wildcards. This is what a self-comparison for repeats and
segmental duplications of a bacterial genome looks like to
seed_extend: most seeds lie far from the sequence ends, so the greedy
flanks are longer than K1's windows.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_ACGT = np.frombuffer(b"acgt", np.uint8)


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


def planted_repeats(seed: int = 2026, nseq: int = 2,
                    length: int = 2_000_000, repeats: int = 150,
                    replen: tuple[int, int] = (1_000, 20_000),
                    wildcard_runs: int = 20) -> list[bytes]:
    """The sequences (lower-case acgt/n bytes) of a planted-repeat
    genome, made from numpy.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 4, length).astype(np.uint8)
            for _ in range(nseq)]
    for _ in range(repeats):
        n = int(rng.integers(replen[0], replen[1] + 1))
        src = seqs[int(rng.integers(0, nseq))]
        a = int(rng.integers(0, length - n))
        copy = src[a:a + n].copy()
        if rng.random() < 0.5:
            copy = 3 - copy[::-1]               # reverse complement
        copy = mutate(rng, copy, rng.uniform(0.01, 0.10))[:n]
        dst = seqs[int(rng.integers(0, nseq))]
        b = int(rng.integers(0, length - copy.size))
        dst[b:b + copy.size] = copy
    text = [_ACGT[s] for s in seqs]
    for _ in range(wildcard_runs):
        t = text[int(rng.integers(0, nseq))]
        p = int(rng.integers(0, length - 100))
        t[p:p + 100] = ord("n")
    return [t.tobytes() for t in text]


def write_fasta(seqs: list[bytes], path: Path, name: str = "seq") -> None:
    """FASTA with 70-column lines."""
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">%s_%d\n" % (name.encode(), i))
            for j in range(0, len(s), 70):
                f.write(s[j:j + 70] + b"\n")
