"""A run on the CPU with the timed path broken underneath: the harness
skips its look for a card and drives the rest of the run, and `correct`
must come out false for each fault the cell can have (an answer
altered where it is produced, half of the answers left out, a state
returned unchanged: the answer of the call before, as a cache keyed on
the wrong thing gives it), and true without a fault."""

import dataclasses

import numpy as np
import pytest


@pytest.fixture
def broken_esa(monkeypatch):
    """build_esa with `fault` applied to what it returns."""
    from genometools_torch.index import esa as esa_mod
    orig = esa_mod.build_esa
    state = {"fault": None, "last": None}

    def patched(*a, **k):
        out = orig(*a, **k)
        if state["fault"] == "stale" and state["last"] is not None:
            out, state["last"] = state["last"], out
        else:
            state["last"] = out
        if state["fault"] == "altered":
            sa = out.suftab.copy()
            sa[[3, 7]] = sa[[7, 3]]
            out = dataclasses.replace(out, suftab=sa)
        elif state["fault"] == "half":
            out = dataclasses.replace(out,
                                      suftab=out.suftab[:out.suftab.size // 2],
                                      lcptab=out.lcptab[:out.lcptab.size // 2])
        return out
    monkeypatch.setattr(esa_mod, "build_esa", patched)
    return state


@pytest.mark.parametrize("cell", ["suffixerator.bacteria",
                                  "suffixerator.maize_chr"])
@pytest.mark.parametrize("fault", [None, "altered", "half", "stale"])
def test_suffixerator_faults(small_cell, cpu_run, broken_esa, cell, fault):
    broken_esa["fault"] = fault
    res = cpu_run(small_cell(cell), seconds=0.5)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["correct"] is (fault is None), res["checks"]


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
def test_seed_extend_faults(small_cell, cpu_run, fused_seed_extend, alter):
    fused_seed_extend["alter"] = alter and alter()
    res = cpu_run(small_cell("seedext.reads_xdrop"), seconds=0.1)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["correct"] is (alter is None), res["checks"]


def test_traced_run_on_the_cpu(small_cell, cpu_run):
    res = cpu_run(small_cell("suffixerator.maize_chr"), seconds=0.3,
                  traced=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"index.encseq_read_ms",
                                   "index.esa_build_ms"}
    assert res["device"]["window_s"] > 0.3
    assert list(res)[-1] == "checks"
    assert len(res["breakdown"]["idle_gaps"]) <= 10


def test_result_line_shape(small_cell, cpu_run):
    res = cpu_run(small_cell("suffixerator.maize_chr"), seconds=0.2)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) == {"setup_s", "suffixes_per_s"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    assert np.isfinite(res["metrics"]["suffixes_per_s"]["value"])
