"""The cell seedext.reads_greedy on the CPU: runs with the timed path
broken underneath (the port's fused host engine stands in for the card's
path, the same lines), its control, and the readers of its two metrics
of its own, greedy.k1_roofline and greedy.rescue_share, on hand-made
records. On the card: one short run through the command BENCHMARK.json
names."""

import json
import subprocess
import sys
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest

from portbench import harness
from portbench.inputs import at1mb_reads
from portbench.peaks import HBM_BYTES_PER_S
from portbench.trace import Span, Trace
# the genome cell's breaks of the timed path, applied here to reads
from test_portbench_genome_greedy import _every_other, _score_up, _stale

ROOT = Path(__file__).resolve().parents[2]
CELL = "seedext.reads_greedy"
Rec = namedtuple("Rec", "id parent thread name start_ns end_ns attrs")
MS = 1_000_000


@pytest.fixture
def reads_cell(monkeypatch):
    """reads_cell(sequences): the cell from BENCHMARK.json, its read set
    shredded from at1MB's first `sequences` sequences, two processes for
    the check."""
    full = at1mb_reads.read_esq
    limit = [0]
    monkeypatch.setattr(at1mb_reads, "read_esq",
                        lambda p: full(p)[:limit[0]])

    def make(sequences):
        limit[0] = sequences
        cell = harness.find_cell(CELL)
        cell.traffic["check"]["processes"] = 2
        return cell
    return make


@pytest.mark.parametrize("alter", [None, _every_other, _score_up, _stale])
def test_reads_greedy_faults(reads_cell, cpu_run, fused_seed_extend, alter):
    fused_seed_extend["alter"] = alter and alter()
    res = cpu_run(reads_cell(12), seed=2147483659, seconds=0.3)
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert res["correct"] is (alter is None), res["checks"]


def test_reads_greedy_control_fails(reads_cell, tmp_path):
    """At at1MB's first 100 sequences (305 reads, some 7,000 segments) a
    perc_mat_history one lower changes some segment's lines."""
    cell = reads_cell(100)
    t = cell.traffic
    inputs = harness.load_part("inputs", t["generator"]).make(
        t["params"], harness.seeded(21, "inputs"), tmp_path)
    ctx = harness.Context(t, cell.config, inputs, 21, "cpu")
    got = harness.load_part("jobs", t["job"]).Job(ctx).control("cpu")
    assert got["segments_differing"][0] > 0, got
    assert got["foreign_lines"][0] == 0


def _traced(records, monkeypatch, kernel_s, jobs=2):
    """A traced run of `jobs` window jobs whose port records are
    `records` and whose K1 kernel took kernel_s seconds."""
    from genometools_torch import trace
    monkeypatch.setattr(trace, "records", lambda: list(records))
    t = Trace(1.0, 0.5, [Span("seed_extend.job", 0, 0, 1000 * MS)],
              {"greedy_full_kernel(int, long*)": kernel_s,
               "greedy_resident_kernel": 9.0})
    return harness.Run(1.0, 0.0, [(0.0, 1.0, {})] * jobs,
                       [("seed_extend.job", 0, 0.0, 1.0)], {}, 0, t)


def _metric(name, run):
    return harness.load_part("metrics", name).read(run)


def test_k1_roofline_counts_flanks_and_results(monkeypatch):
    recs = [Rec(1, None, 0, "greedy.k1", 10 * MS, 20 * MS,
                {"lanes": 1000, "symbols": 900_000, "undone": 3}),
            Rec(2, None, 0, "greedy.rescue", 20 * MS, 30 * MS,
                {"lanes": 3, "symbols": 4000}),
            Rec(3, None, 0, "greedy.k1", 40 * MS, 50 * MS,
                {"lanes": 500, "symbols": 100_000, "undone": 0}),
            # outside the window's jobs: another run's
            Rec(4, None, 0, "greedy.k1", 2000 * MS, 2010 * MS,
                {"lanes": 7, "symbols": 7000, "undone": 0})]
    roofline = harness.load_part("metrics", "greedy.k1_roofline")
    # 1 B a symbol of both flanks, 7 int32 a lane; the rescue's lanes
    # are not counted again
    assert roofline.least_bytes(recs[:3]) == 1_000_000 + 28 * 1500
    run = _traced(recs, monkeypatch, kernel_s=1e-3)
    want = 100.0 * 1_042_000 / HBM_BYTES_PER_S / 1e-3
    assert _metric("greedy.k1_roofline", run) == pytest.approx(want)
    assert _metric("greedy.rescue_share", run) == pytest.approx(0.2)


def test_k1_roofline_none_without_symbols_or_kernel(monkeypatch):
    old = [Rec(1, None, 0, "greedy.k1", 10 * MS, 20 * MS,
               {"lanes": 1000, "undone": 0})]
    assert _metric("greedy.k1_roofline",
                   _traced(old, monkeypatch, 1e-3)) is None
    assert _metric("greedy.rescue_share",
                   _traced(old, monkeypatch, 1e-3)) == 0.0
    new = [Rec(1, None, 0, "greedy.k1", 10 * MS, 20 * MS,
               {"lanes": 1000, "symbols": 5000, "undone": 0})]
    assert _metric("greedy.k1_roofline",
                   _traced(new, monkeypatch, 0.0)) is None
    assert _metric("greedy.rescue_share", _traced([], monkeypatch, 0.0)) \
        is None
    untraced = harness.Run(1.0, 0.0, [(0.0, 1.0, {})], [], {}, 0)
    for m in ("greedy.k1_roofline", "greedy.rescue_share"):
        assert _metric(m, untraced) is None


@pytest.mark.card
def test_reads_greedy_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "2147483659", "--seconds", "2", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    got = res["metrics"]
    for m in ("greedy.k1_ms", "greedy.k1_roofline", "greedy.rescue_share",
              "greedy.batch_ms", "greedy.lanes_per_match"):
        assert np.isfinite(got[m]["value"]), m
    assert 0 < got["greedy.k1_roofline"]["value"] <= 100
