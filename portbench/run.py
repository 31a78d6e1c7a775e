"""Runs one cell of the port's benchmark once and prints its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with as many CUDA cards as
the cell asks for. The run makes its inputs from the seed, warms up on
one job of the cell's own inputs, then runs whole jobs back to back
(one client, a closed loop) until --seconds have passed, and checks a
sample of the window's outputs against the plain reference. The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1
its per-layer metrics, read under the profiler), `device`, with
--trace 1 `breakdown`, and last `checks`, each number compared beside
its limit (also the last lines of standard error).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# one thread for every CPU math library: the run is one client, and
# idle worker threads that spin compete with the host loop for cores
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
               "OPENBLAS_NUM_THREADS")


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var in THREAD_VARS:
        os.environ[var] = "1"
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    started = time.perf_counter() - harness.process_age()
    cell = harness.find_cell(args.workload)
    import torch
    torch.set_num_threads(1)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), workdir,
                          setup_from=started)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             workdir: Path, setup_from: float) -> dict:
    """One run of a cell on `device`; returns the result object.
    setup_from is the perf_counter reading at process start."""
    import torch

    from portbench import harness
    from portbench.trace import Profiled, breakdown
    t = cell.traffic
    gen = harness.load_part("inputs", t["generator"])
    inputs = gen.make(t["params"], harness.seeded(seed, "inputs"), workdir)
    ctx = harness.Context(t, cell.config, inputs, seed, device)
    job = harness.load_part("jobs", t["job"]).Job(ctx)
    job.warm()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    job.reset_counters()
    ctx.spans.clear()
    ctx.traced = traced
    jobs, host, failed = [], [], 0
    prof = Profiled(cuda) if traced else None
    if prof:
        prof.__enter__()
    pauses = _GcPauses()
    steal0 = _steal_s()
    window_start = time.perf_counter()
    setup_s = window_start - setup_from
    try:
        with (_annotation("portbench/window") if traced
              else contextlib.nullcontext()):
            while time.perf_counter() - window_start < seconds:
                ctx.job = len(jobs)
                s, cpu, pcpu, gc_s = (time.perf_counter(), time.thread_time(),
                                      time.process_time(), pauses.seconds)
                try:
                    work = job.run(ctx.job)
                except Exception:
                    traceback.print_exc()
                    failed += 1
                    break
                jobs.append((s, time.perf_counter(), work))
                host.append((time.thread_time() - cpu,
                             time.process_time() - pcpu,
                             pauses.seconds - gc_s))
    finally:
        pauses.close()
        if prof:
            prof.__exit__(None, None, None)
    steal = _steal_s() - steal0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = harness.Run(setup_s, window_start, jobs, list(ctx.spans),
                      job.counters(), peak,
                      prof.trace() if prof else None)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = harness.load_part("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.entry["chips"], "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": len(jobs) + failed,
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = breakdown(run.trace)
        if cuda:
            result["card"] = _power_limit()
    del run, prof
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    last_end = jobs[-1][1] if jobs else window_start
    try:
        checks = job.check(device)
    except Exception:
        traceback.print_exc()
        checks = {"check_raised": (1, 0)}
    print(f"portbench: {cell.name} seed {seed}: set-up {setup_s:.3f} s, "
          f"{len(jobs)} jobs in {last_end - window_start:.3f} s "
          f"from the window's start, check "
          f"{time.perf_counter() - t_check:.3f} s; jobs "
          + " ".join(f"{e - s:.3f}" for s, e, _ in jobs), file=sys.stderr)
    print(f"portbench: host, a job's CPU s of the main thread / of the "
          f"process / GC pauses s: "
          + " ".join(f"{c:.3f}/{p:.3f}/{g:.3f}" for c, p, g in host)
          + f"; steal over the window {steal:.3f} s", file=sys.stderr)
    result["correct"] = bool(jobs) and failed == 0 and all(
        v <= lim for v, lim in checks.values())
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


class _GcPauses:
    """The seconds the interpreter's garbage collector ran while it is
    open."""

    def __init__(self):
        self.seconds, self._t = 0.0, None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, _info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t

    def close(self):
        gc.callbacks.remove(self._cb)


def _steal_s() -> float:
    """CPU seconds the hypervisor gave other guests, summed over this
    machine's CPUs (/proc/stat; nan where it cannot be read)."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return float("nan")


def _annotation(name: str):
    from torch.profiler import record_function
    return record_function(name)


if __name__ == "__main__":
    sys.exit(main())
