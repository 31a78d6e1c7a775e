"""Synthetic genomes with planted repeats and transposons.

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

``planted_transposons`` builds the genome of chip_smoke.py's phase 16
(four 8,000,000 bp sequences, 400 LTR elements of 40 families and 200
TIR elements, numpy seed 2027: the size of a plant chromosome) and the small genomes of the ltr
CPU tests, with the planted coordinates beside them.
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


def _element(rng, kind, rep, innerlen, tsdlen, divergence):
    """(codes, first repeat (start, end), second repeat (start, end)) of
    one element with repeat `rep`, 0-based inclusive from its first
    base: TSD, repeat, inner sequence, the diverged copy (LTR) or
    reverse complement (TIR) of the repeat, TSD."""
    tsd = rng.integers(0, 4, tsdlen).astype(np.uint8)
    inner = rng.integers(0, 4, innerlen).astype(np.uint8)
    copy = mutate(rng, rep, rng.uniform(*divergence))
    if kind == "tir":
        copy = 3 - copy[::-1]
    a = tsdlen
    b = a + rep.size + inner.size
    codes = np.concatenate([tsd, rep, inner, copy, tsd])
    return codes, (a, a + rep.size - 1), (b, b + copy.size - 1)


def planted_transposons(seed: int = 2027, nseq: int = 4,
                        length: int = 8_000_000, ltr: int = 400,
                        tir: int = 200, wildcard_runs: int = 20,
                        divergence: tuple[float, float] = (0.0, 0.10),
                        tsd: bool = True, families: int = 40):
    """A genome of uniform random ACGT with planted transposons, made
    from numpy.random.default_rng(seed): `ltr` LTR elements (two copies
    of a 100-1,000 bp LTR around 1,000-13,000 bp of inner sequence) and
    `tir` TIR elements (a 100-1,000 bp arm and, 500-9,000 bp past its
    end, its reverse complement); the second copy diverged by a uniform
    `divergence` share of substitutions and 0.5 % indels; the LTRs come
    from `families` random consensus sequences, each element's a copy
    with 0-5 % substitutions (0: each its own random LTR); each element
    flanked by a target-site duplication (5 bp for LTR, 2-11 bp for TIR
    elements; none when tsd is False). Elements do not overlap; then
    `wildcard_runs` runs of 100 ``n`` per sequence, clear of them.

    Returns the sequences (lower-case acgt/n bytes) and the planted
    elements as int64 rows (kind 0 = LTR, 1 = TIR; sequence; first
    repeat start, end; second repeat start, end; TSD length), 0-based
    inclusive coordinates within the sequence."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 4, length).astype(np.uint8)
            for _ in range(nseq)]
    consensus = [rng.integers(0, 4, int(rng.integers(100, 1001)))
                 .astype(np.uint8) for _ in range(families)]
    elems = []
    for kind, count in (("ltr", ltr), ("tir", tir)):
        for _ in range(count):
            if kind == "ltr" and families:
                rep = consensus[int(rng.integers(0, families))]
                rep = mutate(rng, rep, rng.uniform(0.0, 0.05), 0)
            else:
                rep = rng.integers(0, 4, int(rng.integers(100, 1001))) \
                    .astype(np.uint8)
            inner = int(rng.integers(1000, 13001) if kind == "ltr"
                        else rng.integers(500, 9001))
            t = (5 if kind == "ltr" else int(rng.integers(2, 12))) \
                if tsd else 0
            elems.append((kind, *_element(rng, kind, rep, inner, t,
                                          divergence), t))
    where = rng.integers(0, nseq, len(elems))
    rows = []
    busy = [np.zeros(length, bool) for _ in range(nseq)]
    for s in range(nseq):
        mine = [elems[i] for i in rng.permutation(np.flatnonzero(where == s))]
        sizes = np.asarray([e[1].size for e in mine], np.int64)
        free = length - int(sizes.sum()) - 200 * len(mine)
        if free < 0:
            raise ValueError("the elements do not fit the sequence")
        starts = np.sort(rng.integers(0, free + 1, len(mine))) + \
            np.concatenate([[0], np.cumsum(sizes + 200)[:-1]]).astype(np.int64)
        for (kind, codes, r1, r2, t), p in zip(mine, starts):
            p = int(p)
            seqs[s][p:p + codes.size] = codes
            busy[s][p:p + codes.size] = True
            rows.append((int(kind == "tir"), s, p + r1[0], p + r1[1],
                         p + r2[0], p + r2[1], t))
    text = [_ACGT[x] for x in seqs]
    for s, t in enumerate(text):
        for _ in range(wildcard_runs):
            # a start whose 100 bp are clear of elements and earlier runs
            c = np.concatenate([[0], np.cumsum(busy[s])])
            free = np.flatnonzero(c[100:] == c[:-100])
            if free.size == 0:
                raise ValueError("no room for a wildcard run")
            p = int(free[rng.integers(0, free.size)])
            t[p:p + 100] = ord("n")
            busy[s][p:p + 100] = True
    planted = np.asarray(sorted(rows), np.int64).reshape(-1, 7)
    return [t.tobytes() for t in text], planted


def write_fasta(seqs: list[bytes], path: Path, name: str = "seq") -> None:
    """FASTA with 70-column lines."""
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">%s_%d\n" % (name.encode(), i))
            for j in range(0, len(s), 70):
                f.write(s[j:j + 70] + b"\n")
