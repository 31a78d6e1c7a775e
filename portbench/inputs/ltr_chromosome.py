"""Input generator: one repeat-rich plant chromosome, as
synthetic.ltr_genome makes it, written as `rotations` FASTA files, each
the chromosome rotated by an offset the run's seed draws: the same
sequence and the same repeats, and every suffix at another position.
The warm-up indexes the last file and the window's jobs the others in
turn, so no job of a window repeats the input of the job before it.

The element copies (every family's consensus and each copy's
mutations) are drawn from the cell's fixed `shape_seed`, so every run
indexes the same set of copies and does the same work; the run's seed
draws the background sequence, where and in which order the copies are
inserted (and so which nest in which) and where the runs of ``n`` go.

Parameters (from the cell): shape_seed, length, te_share, families,
element_len, ltr_len, divergence, indel, tsd, wildcard_runs,
wildcard_len, rotations.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..harness import variant_walks
from .synthetic import ltr_genome, write_fasta


def make(params: dict, rng, workdir: Path) -> dict:
    seq = ltr_genome(np.random.default_rng(params["shape_seed"]), rng,
                     params["length"], params["te_share"],
                     params["families"], tuple(params["element_len"]),
                     tuple(params["ltr_len"]), tuple(params["divergence"]),
                     params["indel"], params["tsd"],
                     params["wildcard_runs"], params["wildcard_len"])
    fastas = []
    for v in range(params["rotations"]):
        r = int(rng.integers(0, len(seq))) if v else 0
        path = workdir / f"chromosome{v}.fna"
        write_fasta(path, [("chr", seq[r:] + seq[:r])])
        fastas.append(path)
    return {"fastas": fastas, **variant_walks(len(fastas))}
