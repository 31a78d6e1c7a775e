"""Time the PyTorch port's readjoiner overlap at several coverages.

    python3 scripts/torch_spm_growth.py [--coverages 20,30]

Run from the root of a checkout on a machine with a CUDA card. For each
coverage, chip_smoke.py's g4m reads (error-free 100 bp reads from
g4m_planted_repeats, numpy seed 1) go through `readjoiner prefilter`
and `readjoiner overlap -l 45` in process, timed as chip_smoke.py's
phase 14 times them; then find_spms(irreducible=False) on the kept
reads times the SPM join without the transitive filter. Prints the
card's name and power limit, and for each coverage its reads, SPMs and
seconds. The work is host code.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from genometools_torch import cli  # noqa: E402
from genometools_torch.assembly import readjoiner as rj  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coverages", default="20,30")
    opts = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; host cores {os.cpu_count()}", flush=True)
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        for cov in (int(c) for c in opts.coverages.split(",")):
            rows = chip_smoke.g4m_reads(cov)[0]
            chip_smoke.reads_fasta(rows, Path("reads.fna"))
            _, tp = chip_smoke.run_cli(cli, ["readjoiner", "prefilter",
                                             "-readset", "rs", "-db",
                                             "reads.fna"])
            _, to = chip_smoke.run_cli(cli, ["readjoiner", "overlap",
                                             "-readset", "rs", "-l", "45"])
            kept = np.load("rs.reads.npz")
            reads = rj.ReadSet(blob=kept["blob"], lens=kept["lens"])
            t0 = time.perf_counter()
            joined = rj.find_spms(reads, 45, irreducible=False)
            tj = time.perf_counter() - t0
            print(f"coverage {cov}x: {rows.shape[0]} reads, "
                  f"{reads.num_reads} kept, "
                  f"{rj.SpmList.read('rs.spm').length.size} SPMs "
                  f"({joined.length.size} before the transitive filter); "
                  f"seconds: prefilter {tp:.3f}, overlap {to:.3f}, "
                  f"find_spms without the transitive filter {tj:.3f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
