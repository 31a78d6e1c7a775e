"""The control of each cell, at a size a test holds: the reference with
the guarantee that would tempt a later change broken, in the program's
place, must come out as not correct. (On the card, at the cells' own
sizes: portbench/control.py.)"""

from portbench import harness


def _job(cell, tmp_path, seed=21):
    t = cell.traffic
    inputs = harness.load_part("inputs", t["generator"]).make(
        t["params"], harness.seeded(seed, "inputs"), tmp_path)
    ctx = harness.Context(t, cell.config, inputs, seed, "cpu")
    return harness.load_part("jobs", t["job"]).Job(ctx)


def test_suffixerator_control_fails(small_cell, tmp_path):
    for name in ("suffixerator.maize_chr", "suffixerator.bacteria"):
        d = tmp_path / name
        d.mkdir()
        got = _job(small_cell(name), d).control("cpu")
        assert got["suftab_mismatches"][0] > 0 or \
            got["lcptab_mismatches"][0] > 0, (name, got)


def test_seed_extend_control_fails(small_cell, tmp_path):
    # enough reads for a below-score one lower to end some matches
    # sooner: at1MB's first 300 sequences, every pair compared
    cell = small_cell("seedext.reads_xdrop", sequences=300)
    cell.traffic["check"]["segments"] = 10 ** 6
    got = _job(cell, tmp_path).control("cpu")
    assert got["segments_differing"][0] > 0, got
    assert got["foreign_lines"][0] == 0
