"""The cell seedext.genome_greedy on the CPU: its frozen generator and
variants, runs with the timed path broken underneath (the port's fused
host engine stands in for the card's path, the same lines), and its
control. On the card: one short run through the command BENCHMARK.json
names."""

import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from portbench import harness
from portbench.inputs import planted_repeats as gen

ROOT = Path(__file__).resolve().parents[2]
CELL = "seedext.genome_greedy"
_COMPLEMENT = bytes.maketrans(b"acgtn", b"tgcan")


def _cell(**params):
    """The cell from BENCHMARK.json at a genome's size a CPU test
    holds."""
    cell = harness.find_cell(CELL)
    cell.traffic["params"].update(params)
    cell.traffic["check"]["processes"] = 2
    return cell


def _small():
    return _cell(length=20_000, repeats=8, replen=[1000, 6000],
                 wildcard_runs=2)


@pytest.mark.parametrize("size", [
    {}, dict(seed=5, length=40_000, repeats=12, replen=(1000, 6000),
             wildcard_runs=2)])
def test_generator_is_the_ports(size):
    from genometools_torch.utils.synthetic import planted_repeats
    assert gen.planted_repeats(**size) == planted_repeats(**size)


def test_variants_hold_the_same_sequences(tmp_path):
    params = dict(harness.find_cell(CELL).traffic["params"], length=30_000,
                  repeats=6, replen=[1000, 4000], wildcard_runs=2)
    seqs = gen.planted_repeats(params["shape_seed"], params["nseq"],
                               params["length"], params["repeats"],
                               tuple(params["replen"]),
                               params["wildcard_runs"])
    inputs = gen.make(params, harness.seeded(2147483659, "inputs"),
                      tmp_path)
    assert len(inputs["fastas"]) == 4 and inputs["warm"] == [3]
    assert inputs["read_bp"] == 2 * 30_000

    def canon(s):
        return min(s, s.translate(_COMPLEMENT)[::-1])
    want = Counter(canon(s) for s in seqs)
    texts = []
    for path in inputs["fastas"]:
        recs = [r for r in path.read_bytes().split(b">")[1:]]
        got = [b"".join(r.split(b"\n")[1:]) for r in recs]
        assert Counter(canon(s) for s in got) == want
        texts.append(tuple(got))
    assert len(set(texts)) == 4


def _every_other():
    return lambda ms: ms[::2]


def _score_up():
    def alter(ms):
        for m in ms:
            m.score += 1
        return ms
    return alter


def _stale():
    """The matches of the call before (the warm-up's, for the first)."""
    last = []

    def alter(ms):
        out = last[0] if last else ms
        last[:] = [ms]
        return out
    return alter


@pytest.mark.parametrize("alter", [None, _every_other, _score_up, _stale])
def test_genome_greedy_faults(cpu_run, fused_seed_extend, alter):
    fused_seed_extend["alter"] = alter and alter()
    res = cpu_run(_small(), seed=2147483659, seconds=0.3)
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert res["correct"] is (alter is None), res["checks"]


def test_genome_greedy_control_fails(tmp_path):
    """At 2 x 40 kbp (shape seed 5, 12 repeats of 1-6 kbp) a
    perc_mat_history one lower changes some segment's lines."""
    cell = _cell(shape_seed=5, length=40_000, repeats=12,
                 replen=[1000, 6000], wildcard_runs=2)
    t = cell.traffic
    inputs = harness.load_part("inputs", t["generator"]).make(
        t["params"], harness.seeded(21, "inputs"), tmp_path)
    ctx = harness.Context(t, cell.config, inputs, 21, "cpu")
    got = harness.load_part("jobs", t["job"]).Job(ctx).control("cpu")
    assert got["segments_differing"][0] > 0, got
    assert got["foreign_lines"][0] == 0


def test_a_checkout_without_the_floor_fails_at_once(monkeypatch,
                                                    tmp_path):
    """The job needs the rounds' floor; where the port lacks it the run
    stops before its warm-up instead of running minutes a job."""
    from genometools_torch.match import seed_extend as se
    monkeypatch.delattr(se, "ROUND_MIN")
    cell = _small()
    t = cell.traffic
    inputs = harness.load_part("inputs", t["generator"]).make(
        t["params"], harness.seeded(1, "inputs"), tmp_path)
    ctx = harness.Context(t, cell.config, inputs, 1, "cpu")
    with pytest.raises(ImportError):
        harness.load_part("jobs", t["job"]).Job(ctx)


@pytest.mark.card
def test_genome_greedy_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert np.isfinite(res["metrics"]["read_bp_per_s"]["value"])
