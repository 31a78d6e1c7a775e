"""The benchmark's plain greedy reference (portbench/reference/greedy.py)
against the port: its greedy extension against the scalar engine
``ops/greedy.py::greedy_extend`` on seeded random flank pairs, its
`gt seed_extend -extendgreedy -l 500 -minidentity 80` lines against the
port's rounds on the CPU and the fused host engine on small planted-
repeat genomes, and its `-l 100 -minidentity 90` lines against the
port's rounds on shredded at1MB reads (on the CPU a slice; on the card,
marked `cuda`, the cell seedext.reads_greedy's whole read set). The
reference imports numpy alone; the port is the witness here, not the
other way round."""

import numpy as np
import pytest

from genometools_torch.core.encseq import Encseq
from genometools_torch.match.seed_extend import SeedExtendParams, seed_extend
from genometools_torch.ops import greedy_batch
from genometools_torch.ops.greedy import PolishingInfo, greedy_extend
from genometools_torch.utils.synthetic import (mutate, planted_repeats,
                                               write_fasta)
from portbench import harness
from portbench.inputs import at1mb_reads
from portbench.inputs.synthetic import write_fasta as write_reads
from portbench.reference import greedy as R
from portbench.reference.fasta import read_records

PARAMS = dict(extension="greedy", userdefinedleastlength=500,
              minidentity=80, sensitivity=97, history=64)


def _flanks(rng):
    """A flank pair: a random u of 0-3,000 symbols and v its copy with
    0-15 % substitutions and 1 % indels, sometimes cut short and
    followed by random symbols (the front dies there), sometimes with a
    run of wildcards in u."""
    u = rng.integers(0, 4, int(rng.integers(0, 3001))).astype(np.uint8)
    v = mutate(rng, u, rng.uniform(0.0, 0.15), 0.01) if u.size else u
    if rng.random() < 0.4:
        cut = int(rng.integers(0, max(v.size, 1)))
        v = np.concatenate([v[:cut], rng.integers(
            0, 4, int(rng.integers(0, 500))).astype(np.uint8)])
    if rng.random() < 0.2 and u.size > 10:
        p = int(rng.integers(0, u.size - 5))
        u[p:p + 5] = 4
    return u, v


@pytest.mark.parametrize("errperc,history", [(20, 64), (10, 64), (5, 40),
                                             (25, 30)])
def test_extension_equals_the_scalar_engine(errperc, history):
    """60 flank pairs a parameter set, 240 in all, in one set of Lanes
    and the first ten one at a time too."""
    rng = np.random.default_rng(1000 + errperc)
    pmh, mad = R.greedy_params(errperc, 97)
    pol = PolishingInfo.new(float(errperc), history)
    pairs = [_flanks(rng) for _ in range(60)]
    seeds = rng.integers(8, 70, len(pairs))
    want = []
    for (u, v), k in zip(pairs, seeds.tolist()):
        d, best = greedy_extend(u, v, max_history=history,
                                perc_mat_history=pmh,
                                maxalignedlendifference=mad, seedlength=k,
                                pol_info=pol)
        want.append((best.alignedlen, best.row, best.distance,
                     best.max_mismatches, d == u.size + v.size + 1))
    died = sum(w[-1] for w in want)
    assert 0 < died < len(want)              # fronts die, and reach ends
    ext = R.Extension(np.concatenate([x for p in pairs for x in p]), pmh,
                      mad, history, R.Polishing(float(errperc), history))
    lens = np.asarray([x.size for p in pairs for x in p]).reshape(-1, 2)
    starts = (np.cumsum(lens) - lens.reshape(-1)).reshape(-1, 2)
    out = R.results(len(pairs))
    one = np.ones(len(pairs), np.int64)
    R.Lanes(ext, (starts[:, 0], one, lens[:, 0], starts[:, 1], one,
                  lens[:, 1]), seeds, out, np.arange(len(pairs))).run()
    got = list(zip(*(out[k].tolist() for k in (
        "alignedlen", "row", "distance", "mismatches", "died"))))
    assert got == want
    for (u, v), k, w in list(zip(pairs, seeds.tolist(), want))[:10]:
        assert R.greedy_extend(u, v, k, pmh, mad, history,
                               R.Polishing(float(errperc), history)) == w


@pytest.fixture(scope="module")
def genome40k(tmp_path_factory):
    """2 x 40 kbp, 12 repeats of 1-6 kbp: the reference's plan and
    lines, and the port's fused engine's lines."""
    path = tmp_path_factory.mktemp("g40k") / "g.fna"
    write_fasta(planted_repeats(5, nseq=2, length=40_000, repeats=12,
                                replen=(1000, 6000), wildcard_runs=2), path)
    plan = R.GreedyPlan(read_records(path), PARAMS)
    ref = plan.walk(plan.segments)
    fused = [m.line() for m in seed_extend(
        Encseq.from_files([str(path)]), None, SeedExtendParams(**PARAMS),
        engine="fused")]
    return plan, ref, fused


def _lines(plan, by_segment):
    return [line for s in plan.segments for line in by_segment[s]]


def test_reference_equals_the_fused_engine(genome40k):
    plan, ref, fused = genome40k
    assert len(plan.segments) == 6 and len(fused) > 10
    assert _lines(plan, ref) == fused


def test_reference_equals_the_rounds_on_the_cpu(tmp_path):
    """The port's default path (the rounds, the plain K1 and K2r) on a
    genome small enough for the plain kernels: 2 x 10 kbp, 4 repeats of
    1-5 kbp, so that flanks longer than K1's 1,536 take the resident
    kernel's plain twin."""
    path = tmp_path / "g.fna"
    write_fasta(planted_repeats(3, nseq=2, length=10_000, repeats=4,
                                replen=(1000, 5000), wildcard_runs=2), path)
    enc = Encseq.from_files([str(path)])
    greedy_batch.reset_stats()
    wave = [m.line() for m in seed_extend(enc, None,
                                          SeedExtendParams(**PARAMS),
                                          device="cpu")]
    assert greedy_batch.stats["resident_lanes"] > 0
    assert greedy_batch.stats["kernel_lanes"] > 0
    fused = [m.line() for m in seed_extend(enc, None,
                                           SeedExtendParams(**PARAMS),
                                           engine="fused")]
    plan = R.GreedyPlan(read_records(path), PARAMS)
    ref = _lines(plan, plan.walk(plan.segments))
    assert len(ref) > 10
    assert ref == wave == fused


READS = dict(PARAMS, userdefinedleastlength=100, minidentity=90)


def _shredded(path, first, last, order_seed):
    """gt shredder's reads of at1MB's sequences first..last-1 as the
    cell seedext.reads_greedy shreds them (-coverage 2, 300-700 bp,
    shred seed 1), written in an order drawn from order_seed."""
    seqs = at1mb_reads.read_esq(at1mb_reads.DATA / "idx")[first:last]
    reads = at1mb_reads.shredder(seqs, 300, 700, 0, 2,
                                 np.random.default_rng(1))
    order = np.random.default_rng(order_seed).permutation(len(reads))
    write_reads(path, [(f"read{i}", reads[j])
                       for i, j in enumerate(order)])


@pytest.mark.parametrize("order_seed", [5, 2147483659])
def test_reference_equals_the_rounds_on_reads(tmp_path, order_seed):
    """The port's default path (the rounds, the plain K1) against the
    reference's walk of every segment, line for line, on the 242 reads
    of at1MB's sequences 200-299: both strands give lines there."""
    path = tmp_path / "reads.fna"
    _shredded(path, 200, 300, order_seed)
    enc = Encseq.from_files([str(path)])
    greedy_batch.reset_stats()
    wave = [m.line() for m in seed_extend(enc, None,
                                          SeedExtendParams(**READS),
                                          device="cpu")]
    assert greedy_batch.stats["kernel_lanes"] > 0
    plan = R.GreedyPlan(read_records(path), READS)
    ref = _lines(plan, plan.walk(plan.segments))
    assert ref == wave
    strands = {line.split()[3] for line in ref}
    assert strands == {"F", "P"}


@pytest.mark.cuda
def test_reference_equals_the_rounds_on_the_whole_read_set(tmp_path):
    """On the card: one job of the cell seedext.reads_greedy (its whole
    read set, an order from a large seed) through the port's normal
    path, against the reference's walk of every segment; K1 takes the
    lanes."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs K1 on the card")
    cell = harness.find_cell("seedext.reads_greedy")
    t, seed = cell.traffic, 2147483659
    inputs = harness.load_part("inputs", t["generator"]).make(
        t["params"], harness.seeded(seed, "inputs"), tmp_path)
    ctx = harness.Context(t, cell.config, inputs, seed,
                          torch.device("cuda", 0))
    job = harness.load_part("jobs", t["job"]).Job(ctx)
    job.reset_counters()
    job.run(0)
    counters = job.counters()
    assert greedy_batch.stats["kernel_lanes"] >= 10_000, counters
    assert counters["matches"] > 1000
    got = job.check(ctx.device)
    assert got == {"foreign_lines": (0, 0),
                   "segments_differing": (0, 0)}, got


def test_control_differs(genome40k):
    """The reference with perc_mat_history one lower (the benchmark's
    control) gives other lines on this genome."""
    plan, ref, _ = genome40k
    ctl = plan.walk(plan.segments, plan.pmh - 1)
    assert sum(ctl[s] != ref[s] for s in plan.segments) > 0


def test_polishing_tables_are_the_ports():
    for err in (5, 20):
        for history in (30, 64):
            pol = PolishingInfo.new(float(err), history)
            mine = R.Polishing(float(err), history)
            assert mine.cut_depth == pol.cut_depth
            assert (mine.diff_from_max == pol.diff_from_max).all()
            assert (mine.score_sum == pol.score_sum).all()


def test_greedy_table_is_the_ports():
    from genometools_torch.ops.greedy import greedy_params_table
    for err in range(0, 35):
        assert R.greedy_params(err, 97) == greedy_params_table(97, err)
    with pytest.raises(ValueError):
        R.greedy_params(20, 90)
