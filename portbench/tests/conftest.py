"""Fixtures of the benchmark's own tests, run from the checkout's root:
``python -m pytest portbench/tests``. Tests marked `card` need a CUDA
card and skip without one; the look for a card is made in the `card`
fixture, never while a module is imported."""

import sys
import tempfile
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each cell shrunk to what a CPU test holds; the traffic's shape stays
SMALL = {
    "suffixerator.maize_chr": {
        "params": dict(length=300_000, families=4, element_len=[2000, 5000],
                       ltr_len=[100, 400])},
    "suffixerator.bacteria": {
        "params": dict(genomes=6, median_bp=50_000,
                       clip_bp=[20_000, 200_000], plasmid_bp=[2000, 5000],
                       repeat_bp=[500, 1000]),
        "check": dict(jobs_kept=4)},
    "seedext.reads_xdrop": {"check": dict(jobs_kept=2, segments=300)},
}
AT1MB_SEQUENCES = 12       # the shrunk read set shreds at1MB's first ones


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda", 0)


@pytest.fixture
def small_cell(monkeypatch):
    """small_cell(name, sequences): the cell from BENCHMARK.json, shrunk;
    a read set shreds at1MB's first `sequences` sequences."""
    from portbench import harness
    from portbench.inputs import at1mb_reads
    full, limit = at1mb_reads.read_esq, [AT1MB_SEQUENCES]
    monkeypatch.setattr(at1mb_reads, "read_esq",
                        lambda p: full(p)[:limit[0]])

    def make(name, sequences=AT1MB_SEQUENCES):
        limit[0] = sequences
        cell = harness.find_cell(name)
        for part, over in SMALL[name].items():
            cell.traffic[part].update(over)
        return cell
    return make


@pytest.fixture
def cpu_run():
    """cpu_run(cell, seed, seconds): one run on the CPU, the look for a
    card skipped, through run.py's run_cell."""
    import importlib.util

    import torch
    spec = importlib.util.spec_from_file_location(
        "portbench_run", ROOT / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def run(cell, seed=11, seconds=0.2, traced=False):
        with tempfile.TemporaryDirectory() as d:
            return mod.run_cell(cell, seed, seconds, traced,
                                torch.device("cpu"), Path(d),
                                time.perf_counter())
    return run


@pytest.fixture
def fused_seed_extend(monkeypatch):
    """The port's seed_extend through its fused host engine (the same
    lines; the plain K3 is too slow for a CPU test), with `alter`
    applied to its matches: the timed path broken underneath."""
    from genometools_torch.match import seed_extend as se
    orig = se.seed_extend
    state = {"alter": None}

    def patched(aenc, benc=None, params=None, events=None, device="cuda",
                engine="wave", wave=se.WAVE):
        ms = orig(aenc, benc, params, engine="fused")
        return state["alter"](ms) if state["alter"] else ms
    monkeypatch.setattr(se, "seed_extend", patched)
    return state
