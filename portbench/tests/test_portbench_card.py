"""On the card only: one short run of each cell through the command
BENCHMARK.json names, its last line read back."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["suffixerator.bacteria",
                                  "seedext.reads_xdrop",
                                  "suffixerator.maize_chr"])
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"


def test_no_card_no_result(tmp_path):
    """Without a card (or a CPU-only torch) the command prints no result
    and exits non-zero; this holds here, and is skipped on the card."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is attached")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "suffixerator.bacteria", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
