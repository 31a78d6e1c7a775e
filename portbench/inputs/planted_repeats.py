"""Input generator: the planted-repeat bacterial genome (g4m), two
sequences of 2,000,000 bp with 150 repeat copies of 1,000-20,000 bp,
half of them reverse-complemented, each with 1-10 % substitutions and
0.5 % indels, and 20 runs of 100 ``n``.

Frozen here: ``planted_repeats`` is copied verbatim from
``genometools_torch/utils/synthetic.py`` at commit fe3260e57157 (the
genome that chip_smoke.py's phase 7 aligns), with ``mutate`` from
``synthetic.py`` beside this file. The genome is made from the cell's
fixed `shape_seed`, so every run holds the same sequences and copies
and does the same work. The run's seed draws how it is written: four
variants, the two sequences in either order, and for each sequence
the strand it is written on (drawn once; the variants that flip take
the other strand of both). The warm-up aligns the last variant and the
window's jobs the others in turn, so no job of a window repeats the
input of the job before it.

Parameters (from the cell): shape_seed, nseq, length, repeats, replen,
wildcard_runs.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..harness import variant_walks
from .synthetic import mutate, write_fasta

_ACGT = np.frombuffer(b"acgt", np.uint8)


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


_COMPLEMENT = bytes.maketrans(b"acgtn", b"tgcan")


def variants(seqs: list[bytes], rng) -> list[list[tuple[str, bytes]]]:
    """The genome's four variants, each a list of (name, sequence)
    records: the given order or its reverse, times the strands drawn
    from rng or their opposite."""
    flip = rng.random(len(seqs)) < 0.5
    out = []
    for order in (1, -1):
        for other in (False, True):
            recs = []
            for i in range(len(seqs))[::order]:
                rc = bool(flip[i]) != other
                s = seqs[i].translate(_COMPLEMENT)[::-1] if rc else seqs[i]
                recs.append((f"seq{i}{'_rc' if rc else ''}", s))
            out.append(recs)
    return [out[i] for i in rng.permutation(len(out))]


def make(params: dict, rng, workdir: Path) -> dict:
    seqs = planted_repeats(params["shape_seed"], params["nseq"],
                           params["length"], params["repeats"],
                           tuple(params["replen"]), params["wildcard_runs"])
    fastas = []
    for v, recs in enumerate(variants(seqs, rng)):
        path = workdir / f"genome{v}.fna"
        write_fasta(path, recs)
        fastas.append(path)
    return {"fastas": fastas, **variant_walks(len(fastas)),
            "read_bp": sum(len(s) for s in seqs)}
