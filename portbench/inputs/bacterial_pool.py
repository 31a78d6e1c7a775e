"""Input generator: a collection of bacterial assemblies, one FASTA
file each (a chromosome and its plasmids), and the seeded order in
which the jobs of a run walk it.

The collection's shape (every chromosome, plasmid and repeat size, the
number of copies of each repeat, each genome's GC share) and the
repeat copies themselves (segments, mutations, strands) are drawn from
the cell's fixed `shape_seed`, so every run indexes the same sizes and
refines the same ties; the run's seed draws the rest of the sequence,
where the copies land and the walk's order. Chromosome lengths sit at the
quantiles (i + 0.5) / genomes of a lognormal with the cell's median
and sigma, clipped to its range.

Parameters (from the cell): genomes, shape_seed, median_bp, sigma,
clip_bp, plasmids, plasmid_bp, gc, repeat_families, repeat_copies,
repeat_bp, repeat_divergence.
"""

from __future__ import annotations

import math
from pathlib import Path
from statistics import NormalDist

import numpy as np

from .synthetic import bacterial_genome, write_fasta


def shape(params: dict) -> list[tuple[int, list[int], list, float]]:
    """(chromosome length, plasmid lengths, repeat families as (segment
    length, copies), GC share) of each genome."""
    g = params["genomes"]
    lo, hi = params["clip_bp"]
    z = [NormalDist().inv_cdf((i + 0.5) / g) for i in range(g)]
    chrom = [int(min(max(params["median_bp"] * math.exp(params["sigma"] * x),
                         lo), hi)) for x in z]
    srng = np.random.default_rng(params["shape_seed"])
    plo, phi = params["plasmid_bp"]
    (nlo, nhi), (rlo, rhi) = params["plasmids"], params["repeat_bp"]
    clo, chi = params["repeat_copies"]
    out = []
    for c in srng.permutation(chrom).tolist():
        plasmids = [int(srng.integers(plo, phi + 1))
                    for _ in range(int(srng.integers(nlo, nhi + 1)))]
        repeats = [(int(srng.integers(rlo, rhi + 1)),
                    int(srng.integers(clo, chi + 1)))
                   for _ in range(params["repeat_families"])]
        out.append((c, plasmids, repeats,
                    float(srng.uniform(*params["gc"]))))
    return out


def make(params: dict, rng, workdir: Path) -> dict:
    fastas = []
    for i, (chrom, plasmids, repeats, gc) in enumerate(shape(params)):
        seqs = bacterial_genome(
            np.random.default_rng([params["shape_seed"], i]), rng, chrom,
            gc, plasmids, repeats, tuple(params["repeat_divergence"]))
        path = workdir / f"genome{i:02d}.fna"
        write_fasta(path, [(f"g{i}_chromosome", seqs[0])] +
                    [(f"g{i}_plasmid{j}", s) for j, s in
                     enumerate(seqs[1:], 1)])
        fastas.append(path)
    order = rng.permutation(len(fastas)).tolist()
    return {"fastas": fastas, "walks": [order], "warm": order}
