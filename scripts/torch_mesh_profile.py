"""Where the sharded suffix sort's time goes on one card: 8 shards or 1.

    python3 scripts/torch_mesh_profile.py [--n 33554436] [--shards 8]

Sorts the suffixes of n keys (n - 1 random ACGT symbols from a
torch.Generator with seed 42 on the card, the sentinel last) with the
sample-sort engine of genometools_torch/parallel/dist_doubling_sharded
on int32 lanes, on Mesh([cuda:0] * shards) and on Mesh([cuda:0]): each
once to warm up, once timed (host clock, the card synchronised) and
once under torch.profiler. Prints the card's name and power limit,
each run's seconds, its device time by class of kernel (sorts; copies
and concatenations; index scatters and gathers; the rest) and its ten
kernels with the most device time. The two suffix arrays
must be equal.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CLASSES = (("sorts", ("sort",)),
           ("copies and concatenations", ("memcpy", "copy", "cat")),
           ("index scatters and gathers", ("index", "scatter", "gather",
                                           "take")))


def device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def op_class(name: str) -> str:
    low = name.lower()
    for label, words in CLASSES:
        if any(w in low for w in words):
            return label
    return "the rest"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2 ** 25 + 4)
    ap.add_argument("--shards", type=int, default=8)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_mesh_profile: no CUDA card")
    from genometools_torch.parallel.dist_doubling_sharded import \
        sharded_build_sa_sample
    from genometools_torch.parallel.mesh import Mesh, gather
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(42)
    n = opts.n
    keys = torch.randint(0, 4, (n,), generator=g, dtype=torch.int32,
                         device=dev)
    keys[-1] = 4 + n - 1
    sas = []
    for P in (opts.shards, 1):
        npad = -(-n // P) * P
        kp = torch.cat([keys, 4 + n + torch.arange(
            npad - n, dtype=torch.int32, device=dev)])
        mesh = Mesh([dev] * P)
        def run():
            return sharded_build_sa_sample(kp, npad, mesh)
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sa, ovf = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        sas.append(gather(sa)[:n])
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        # the kernels' own rows (their operators' rows would count them
        # again)
        evts = [e for e in prof.key_averages() if device_us(e) > 0]
        kern = [e for e in evts if "CUDA" in str(getattr(e, "device_type",
                                                         ""))]
        evts = kern or evts
        total = sum(device_us(e) for e in evts)
        by_class = {}
        for e in evts:
            c = op_class(e.key)
            by_class[c] = by_class.get(c, 0.0) + device_us(e)
        print(f"{P} shard(s): {dt:.3f}s on the host clock, overflow flag "
              f"{ovf}; device time {total / 1e3:.3f} ms under the profiler"
              f" ({len(evts)} kernels with device time)")
        for c, us in sorted(by_class.items(), key=lambda x: -x[1]):
            print(f"  {c}: {us / 1e3:.3f} ms ({100 * us / max(total, 1):.1f}"
                  f" %)")
        for e in sorted(evts, key=lambda e: -device_us(e))[:10]:
            print(f"    {e.key}: {device_us(e) / 1e3:.3f} ms, {e.count} "
                  f"calls")
    if not torch.equal(sas[0], sas[1]):
        raise SystemExit("the two suffix arrays differ")
    print("the suffix arrays are equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
