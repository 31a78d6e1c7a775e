"""The benchmark's machinery, shared by every cell: finding a cell's
files by name, the run's context (device, seeds, spans), the measured
window, and the arithmetic the metric readers share.

A cell is found by its name in BENCHMARK.json: its traffic in
portbench/cells/<cell>.json (the input generator, its parameters, the
job runner and the check's sizes), its configuration in the file that
BENCHMARK.json names, its generator in portbench/inputs/<generator>.py,
its job runner in portbench/jobs/<job>.py and each of its metrics'
readers in portbench/metrics/<metric>.py.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "genometools_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: dict          # the workload's entry in BENCHMARK.json
    traffic: dict        # portbench/cells/<name>.json
    config: dict         # the configuration's file
    end_to_end: list     # the cell's end-to-end metric entries
    per_layer: list      # the cell's per-layer metric entries


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if "workloads" not in m or
            cell in m["workloads"]]


def find_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(name, entry, load_json(HERE / "cells" / f"{name}.json"),
                load_json(ROOT / conf["file"]),
                _for_cell(bench["end_to_end"], name),
                _for_cell(bench["per_layer"], name))


def load_part(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if "." not in name:
        return importlib.import_module(f"portbench.{kind}.{name}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seeded(seed: int, salt: str) -> np.random.Generator:
    """A generator of its own for each use of the run's seed."""
    return np.random.default_rng([seed % (1 << 63), zlib.crc32(salt.encode())])


def variant_walks(variants: int) -> dict:
    """The "walks" and "warm" of a generator's inputs whose `variants`
    files are variants of one input: a job takes one, in turn, and the
    warm-up the last, so no window job repeats the input before it."""
    if variants == 1:
        return {"walks": [[0]], "warm": [0]}
    return {"walks": [[v] for v in range(variants - 1)],
            "warm": [variants - 1]}


class Reservoir:
    """A uniform sample of at most `size` items of a stream of unknown
    length (Vitter's algorithm R), drawn from its own generator."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self._items = size, rng, {}
        self._seen = 0

    def offer(self, key, item) -> None:
        self._seen += 1
        if len(self._items) < self.size:
            self._items[key] = item
            return
        j = int(self.rng.integers(0, self._seen))
        if j < self.size:
            del self._items[sorted(self._items)[j]]
            self._items[key] = item

    def items(self) -> list:
        return sorted(self._items.items(), key=lambda kv: kv[0])


@dataclass
class Context:
    """What a job runner sees of its run."""
    cell: dict           # the traffic file
    config: dict
    inputs: dict
    seed: int
    device: object
    traced: bool = False
    job: int = -1        # the job running now (-1: warm-up)
    spans: list = field(default_factory=list)

    def rng(self, salt: str) -> np.random.Generator:
        return seeded(self.seed, salt)

    def reservoir(self, size: int) -> Reservoir:
        return Reservoir(size, self.rng("reservoir"))

    @contextlib.contextmanager
    def span(self, name: str):
        if self.traced:
            from torch.profiler import record_function
            rf = record_function(f"portbench/{name}/{self.job}")
        else:
            rf = contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        self.spans.append((name, self.job, t0, time.perf_counter()))


@dataclass
class Run:
    """What the metric readers see of a run."""
    setup_s: float
    window_start: float
    jobs: list                # (start, end, work dict), window jobs
    spans: list               # (name, job, start, end), window jobs
    counters: dict
    peak_bytes: int
    trace: object = None      # trace.Trace in the traced run

    def total(self, key: str) -> float:
        return float(sum(w.get(key, 0) for _, _, w in self.jobs))

    def rate(self, key: str) -> float | None:
        """The sum of `key` over every job of the window over the time
        from the window's start to the last job's end."""
        if not self.jobs:
            return None
        return self.total(key) / (self.jobs[-1][1] - self.window_start)

    def span_mean_ms(self, name: str) -> float | None:
        d = [e - s for n, _, s, e in self.spans if n == name]
        return 1e3 * sum(d) / len(d) if d else None


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), interpolated linearly between the
    closest ranks (numpy's default)."""
    x = sorted(values)
    if not x:
        raise ValueError("no values")
    h = (len(x) - 1) * q / 100.0
    lo = math.floor(h)
    hi = min(lo + 1, len(x) - 1)
    return x[lo] + (h - lo) * (x[hi] - x[lo])


def process_age() -> float:
    """Seconds since this process started (Linux; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rpartition(")")[2].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))
