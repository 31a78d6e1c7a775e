"""The control of a cell at the cell's own size: the plain reference,
with the guarantee that would tempt a later change broken, put in the
program's place, and the cell's numbers compared as a run compares
them. It has to come out as not correct on every seed.

    python3 portbench/control.py --workload <cell> --seeds <n>[,<n>...]

suffixerator cells: the reference's sort stopped at 2**control_depth_log2
keys (refinement skipped, ties left in position order). seedext cells:
the reference's X-drop with a below-score one lower. Prints one JSON
line a seed with the numbers beside their limits. The program is not
run; the cell's inputs are made from each seed as a run makes them.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness
    cell = harness.find_cell(args.workload)
    t = cell.traffic
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        workdir = Path(tempfile.mkdtemp(prefix="portbench-control-"))
        try:
            t0 = time.perf_counter()
            inputs = harness.load_part("inputs", t["generator"]).make(
                t["params"], harness.seeded(seed, "inputs"), workdir)
            ctx = harness.Context(t, cell.config, inputs, seed, device)
            got = harness.load_part("jobs", t["job"]).Job(ctx).control(
                device)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "correct": all(v <= lim for v, lim in got.values()),
            "seconds": time.perf_counter() - t0,
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in got.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
