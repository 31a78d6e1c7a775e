"""genometools_torch seed_extend (the rounds walk, CPU plain kernels)
against the reference seed_extend (its fused host engine on the CPU),
greedy and xdrop, line for line."""

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from genometools_torch.match import ext_workload as tew
from genometools_torch.match import seed_extend as tse
from genometools_torch.ops import kmer as tk

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden_esa"


def _random_enc(seed, nseq=3, n=2500):
    """The inputs of tests/test_seed_extend.py TestFusedEngineEquivalence:
    random sequences sharing a planted repeat."""
    from genometools_tpu.core.encseq import Encseq
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(nseq):
        base = "".join(rng.choice(list("acgt"), n))
        parts.append(base[:1200] + base[100:400] + base[1200:])
    return Encseq.from_string("|".join(parts))


def _tandem_enc(arrays, length=1900, flank=50):
    """One sequence a (unit, substitution rate, seed) of `arrays`: tandem
    copies of a random unit, each copy diverged by its own substitutions,
    between random flanks. A segment of such copies needs dozens of
    extensions one after another, each skipping only some of the next
    seeds."""
    from genometools_tpu.core.encseq import Encseq
    parts = []
    for unit, sub, seed in arrays:
        rng = np.random.default_rng(seed)
        u = rng.integers(0, 4, unit)
        copies = []
        for _ in range(length // unit):
            c = u.copy()
            m = rng.random(unit) < sub
            c[m] = (c[m] + rng.integers(1, 4, m.sum())) % 4
            copies.append(c)
        s = np.concatenate([rng.integers(0, 4, flank), *copies,
                            rng.integers(0, 4, flank)])
        parts.append("".join(np.array(list("acgt"))[s]))
    return Encseq.from_string("|".join(parts))


def _hairpin_enc(seed=4):
    """Random sequences, each with an inverted repeat and, near its
    middle, a hairpin: on the P strand the hairpin's seeds are
    same-sequence overlapping instances, between seeds the walk
    extends."""
    from genometools_tpu.core.encseq import Encseq
    rng = np.random.default_rng(seed)
    comp = str.maketrans("acgt", "tgca")
    parts = []
    for _ in range(3):
        x, y, b = ("".join(rng.choice(list("acgt"), n))
                   for n in (100, 120, 1200))
        rc = lambda z: z[::-1].translate(comp)
        parts.append(b[:200] + y + b[200:595] + x + rc(x) + b[595:900] +
                     rc(y) + b[900:])
    return Encseq.from_string("|".join(parts))


@contextlib.contextmanager
def _walks():
    """The attributes of the seedext.walk spans recorded inside."""
    from genometools_torch import trace
    trace.clear()
    trace.enable()
    walks: list = []
    try:
        yield walks
        walks.extend(r.attrs for r in trace.records()
                     if r.name == "seedext.walk")
    finally:
        trace.enable(False)
        trace.clear()


def _golden_enc(db):
    from genometools_tpu.core.encseq import Encseq
    return Encseq.load(str(GOLDEN / db / "idx"))


def _both(enc, monkeypatch, events=None, **kw):
    from genometools_tpu.match import seed_extend as rse
    monkeypatch.delenv("GT_TPU_DEVICE_EXTEND", raising=False)
    p = rse.SeedExtendParams(**kw)
    ref_events = [] if events is not None else None
    ref = [m.line() for m in rse.seed_extend(enc, None, p,
                                             events=ref_events)]
    got = [m.line() for m in tse.seed_extend(
        enc, None, tse.params_from_reference(p), events=events,
        device="cpu")]
    return ref, got, ref_events


@pytest.mark.parametrize("extension,seed", [("greedy", 21), ("xdrop", 22)])
def test_random_inputs_match_reference(monkeypatch, extension, seed):
    ref, got, _ = _both(_random_enc(seed), monkeypatch, seedlength=12,
                        minidentity=85, extension=extension,
                        userdefinedleastlength=20)
    assert got == ref and ref


@pytest.mark.parametrize("extension,seed", [("greedy", 31), ("xdrop", 32)])
def test_small_waves_match_reference(monkeypatch, extension, seed):
    """wave=2 caps each batch of extensions at two seeds: a round's
    candidates go in several batches, and the lines still equal the
    reference's."""
    from genometools_tpu.match import seed_extend as rse
    waves = []
    batch = tse._batch_extensions
    monkeypatch.setattr(tse, "_batch_extensions",
                        lambda c, *a: waves.append(len(c)) or batch(c, *a))
    enc = _random_enc(seed)
    p = rse.SeedExtendParams(seedlength=12, minidentity=85,
                             extension=extension, userdefinedleastlength=20)
    ref = [m.line() for m in rse.seed_extend(enc, None, p)]
    got = [m.line() for m in tse.seed_extend(
        enc, None, tse.params_from_reference(p), device="cpu", wave=2)]
    assert got == ref and ref
    assert max(waves) <= 2 < sum(waves), waves


@pytest.mark.parametrize("extension", ["greedy", "xdrop"])
def test_duplicate_golden_matches_reference(monkeypatch, extension):
    ref, got, _ = _both(_golden_enc("Duplicate.fna"), monkeypatch,
                        minidentity=90, extension=extension,
                        userdefinedleastlength=14)
    assert got == ref and ref


def test_failed_seed_events_match_reference(monkeypatch):
    events = []
    ref, got, ref_events = _both(_golden_enc("Atinsert.fna"), monkeypatch,
                                 events=events, minidentity=90,
                                 extension="greedy",
                                 userdefinedleastlength=14)
    assert got == ref
    line = lambda e: e if e[0] == "failed" else ("match", e[1].line())
    assert [line(e) for e in events] == [line(e) for e in ref_events]
    assert any(e[0] == "failed" for e in events)


@pytest.mark.parametrize("extension", ["xdrop", "greedy"])
def test_tandem_copies_match_reference(monkeypatch, extension):
    """Diverged tandem copies: a segment's walk takes well over 12
    rounds (with no floor under a round, ROUND_MIN 0), and the lines
    equal the reference's fused engine."""
    monkeypatch.setattr(tse, "ROUND_MIN", 0)
    enc = _tandem_enc([(30, 0.08, 3), (40, 0.15, 2), (20, 0.15, 2)])
    with _walks() as walks:
        ref, got, _ = _both(enc, monkeypatch, seedlength=12, minidentity=80,
                            extension=extension, userdefinedleastlength=30)
    assert got == ref and ref
    assert max(w["rounds"] for w in walks) > 15, walks


def test_xdrop_events_match_reference(monkeypatch):
    """xdrop events, failed seeds and the P strand's same-sequence
    overlapping instances among them, in the reference's order."""
    events = []
    k = 12
    ref, got, ref_events = _both(_hairpin_enc(), monkeypatch, events=events,
                                 seedlength=k, minidentity=85,
                                 extension="xdrop", userdefinedleastlength=20)
    assert got == ref and ref
    line = lambda e: e if e[0] == "failed" else ("match", e[1].line())
    assert [line(e) for e in events] == [line(e) for e in ref_events]
    failed = [e for e in events if e[0] == "failed"]
    overlaps = [e for e in failed if e[4] == "P" and e[2] == e[5] and
                e[3] + k - 1 >= e[6]]
    assert overlaps and len(overlaps) < len(failed)


@pytest.mark.parametrize("use_apos,extension,source", [
    (1, "xdrop", "tandem"), (1, "greedy", "tandem"), (2, "xdrop", "tandem"),
    (2, "greedy", "tandem"), (1, "xdrop", "hairpin"),
    (2, "greedy", "hairpin")])
def test_use_apos_matches_reference(monkeypatch, use_apos, extension,
                                    source):
    """-use_apos 1 and 2: seeds inside a previous match's rectangle are
    skipped, on the F strand and among the P strand's overlapping
    instances; the lines equal the reference package's and differ from
    those of use_apos 0."""
    from genometools_tpu.match import seed_extend as rse
    if source == "tandem":
        enc = _tandem_enc([(30, 0.08, 3), (20, 0.15, 2)], length=600)
        kw = dict(minidentity=80, userdefinedleastlength=30)
    else:
        enc = _hairpin_enc()
        kw = dict(minidentity=85, userdefinedleastlength=20)
    kw.update(seedlength=12, extension=extension)
    ref, got, _ = _both(enc, monkeypatch, use_apos=use_apos, **kw)
    assert got == ref and ref
    assert ref != [m.line() for m in rse.seed_extend(
        enc, None, rse.SeedExtendParams(**kw))]


@pytest.mark.parametrize("extension", ["xdrop", "greedy"])
def test_host_route_matches_reference(monkeypatch, extension):
    """Parameters the batches do not take (xdrop with non-unit scores,
    greedy with a history under 30) take the host extension in the same
    rounds: lines and events equal the reference's."""
    from genometools_tpu.ops.xdrop import XdropScores
    kw = dict(history=20) if extension == "greedy" else \
        dict(scores=XdropScores(mat=2, mis=-3, ins=-3, del_=-3))
    batches = []
    monkeypatch.setattr(tse, "_batch_extensions",
                        lambda *a: batches.append(a))
    events = []
    ref, got, ref_events = _both(_hairpin_enc(), monkeypatch, events=events,
                                 seedlength=12, minidentity=85,
                                 extension=extension,
                                 userdefinedleastlength=20, **kw)
    assert got == ref and ref
    line = lambda e: e if e[0] == "failed" else ("match", e[1].line())
    assert [line(e) for e in events] == [line(e) for e in ref_events]
    assert not batches


@pytest.mark.parametrize("source,extension", [
    ("Duplicate.fna", "xdrop"), ("Duplicate.fna", "greedy"),
    (21, "greedy"), (22, "xdrop")])
def test_extensions_bounded_by_the_sequential_walk(monkeypatch, source,
                                                   extension):
    """With no floor under a round (ROUND_MIN 0), the rounds extend at
    most twice the seeds the reference's sequential walk extends (one
    host extension for each seed it reaches, none for an overlapping
    instance), and use exactly those."""
    monkeypatch.setattr(tse, "ROUND_MIN", 0)
    extensions, lanes, _ = _walk_extensions(monkeypatch, source, extension)
    assert extensions <= lanes <= 2 * extensions


@pytest.mark.parametrize("source,extension", [
    ("Duplicate.fna", "xdrop"), ("Duplicate.fna", "greedy"),
    (21, "greedy"), (22, "xdrop")])
def test_round_floor_bounds_the_extensions(monkeypatch, source, extension):
    """With the floor under a round (ROUND_MIN), the rounds extend at
    most twice the seeds the sequential walk extends and ROUND_MIN more
    a round, use exactly those, and take no more rounds than without
    it."""
    extensions, lanes, rounds = _walk_extensions(monkeypatch, source,
                                                 extension)
    assert extensions <= lanes <= 2 * extensions + tse.ROUND_MIN * rounds
    monkeypatch.setattr(tse, "ROUND_MIN", 0)
    assert rounds <= _walk_extensions(monkeypatch, source, extension)[2]


def _walk_extensions(monkeypatch, source, extension):
    """(seeds the reference's sequential walk extends, seeds the rounds
    extend, rounds) of one run, its lines equal to the reference's."""
    from genometools_tpu.match import seed_extend as rse
    if isinstance(source, str):
        enc = _golden_enc(source)
        kw = dict(minidentity=90, userdefinedleastlength=14)
    else:
        enc = _random_enc(source)
        kw = dict(seedlength=12, minidentity=85, userdefinedleastlength=20)
    p = rse.SeedExtendParams(extension=extension, **kw)
    monkeypatch.setenv("GT_TPU_NO_DEVICE_EXTEND", "1")
    reached = []
    one = rse._extend_one_seed
    monkeypatch.setattr(rse, "_extend_one_seed", lambda *a: (
        lambda e: reached.append(e is not None) or e)(one(*a)))
    events = []
    ref = [m.line() for m in rse.seed_extend(enc, None, p, events=events)]
    lanes = []
    batch = tse._batch_extensions
    monkeypatch.setattr(tse, "_batch_extensions",
                        lambda c, *a: lanes.append(len(c)) or batch(c, *a))
    with _walks() as walks:
        got = [m.line() for m in tse.seed_extend(
            enc, None, tse.params_from_reference(p), device="cpu")]
    monkeypatch.undo()
    assert got == ref and ref
    extensions = sum(reached)
    assert len(events) >= extensions
    assert sum(w["used"] for w in walks) == extensions
    assert sum(lanes) == sum(w["extended"] for w in walks)
    return extensions, sum(lanes), sum(w["rounds"] for w in walks)


def test_fused_engine_is_the_reference_engine():
    from genometools_tpu.match import seed_extend as rse
    enc = _golden_enc("Atinsert.fna")
    p = rse.SeedExtendParams(minidentity=90, extension="greedy",
                             userdefinedleastlength=14)
    ref = [m.line() for m in rse.seed_extend(enc, None, p)]
    got = [m.line() for m in tse.seed_extend(
        enc, None, tse.params_from_reference(p), engine="fused")]
    assert got == ref and ref


# Atinsert cut at 2,000 tasks stays on the F strand; the whole of
# Duplicate holds thousands of P-strand tasks
@pytest.mark.parametrize("db,max_tasks", [("Atinsert.fna", 2000),
                                          ("Duplicate.fna", None)])
@pytest.mark.parametrize("form", ["collect_extension_pool",
                                  "collect_extension_tasks"])
def test_extension_workload_matches_reference(form, db, max_tasks):
    from genometools_tpu.match import ext_workload as rew
    from genometools_tpu.match.seed_extend import SeedExtendParams
    enc = _golden_enc(db)
    ref = getattr(rew, form)(enc, SeedExtendParams(extension="greedy"),
                             max_tasks=max_tasks)
    got = getattr(tew, form)(enc, tse.SeedExtendParams(extension="greedy"),
                             max_tasks=max_tasks)
    if form == "collect_extension_tasks":      # ([(u, v), ...], k)
        ref = [*(x for pair in ref[0] for x in pair), ref[1]]
        got = [*(x for pair in got[0] for x in pair), got[1]]
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), np.asarray(g))


@pytest.mark.parametrize("case", ["kmer_codes_np", "spaced_kmer_codes_np",
                                  "words_to_int", "pack_mers_2bit"])
def test_kmer_helpers_match_reference(case):
    from genometools_tpu.ops import kmer as rk
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 500).astype(np.uint8)
    codes[rng.choice(500, 20, replace=False)] = 254
    args = {"kmer_codes_np": (codes, 12),
            "spaced_kmer_codes_np": (codes, 0b1101101011),
            "words_to_int": (rng.integers(0, 1 << 30, (2, 50)), 20),
            "pack_mers_2bit": (rng.integers(0, 1 << 40, 50), 22)}[case]
    ref = getattr(rk, case)(*args)
    got = getattr(tk, case)(*args)
    for r, g in zip(ref if isinstance(ref, tuple) else [ref],
                    got if isinstance(got, tuple) else [got]):
        assert np.array_equal(r, g)


def test_unported_options_raise(monkeypatch, tmp_path):
    """-dist (the grid's cells on a mesh's lanes, ported) and -parts 2
    run and equal the reference."""
    from genometools_torch.cli import main
    enc = _golden_enc("Atinsert.fna")
    enc.save(str(tmp_path / "idx"))
    ref, got, _ = _both(enc, monkeypatch, minidentity=90,
                        extension="greedy", userdefinedleastlength=14,
                        parts=2)
    assert got == ref and ref
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["seed_extend", "-ii", str(tmp_path / "idx"), "-l", "14",
              "-minidentity", "90", "-dist", "-parts", "2", "-device",
              "cpu"])
    assert buf.getvalue().splitlines() == ref


def test_planted_repeats_take_the_chunk_route(monkeypatch, tmp_path):
    """A small g4m_planted_repeats-style genome (2 x 50 kbp, six repeats
    of 3-8 kbp): the greedy flanks are longer than K1's windows, so the
    wave path runs the windowed chunk loop (the resident kernel's plain
    version here),
    and the lines equal the fused engine's and the reference's."""
    from genometools_tpu.core.encseq import Encseq as RefEncseq
    from genometools_tpu.match import seed_extend as rse

    from genometools_torch.core.encseq import Encseq
    from genometools_torch.ops import greedy_batch as tgb
    from genometools_torch.utils.synthetic import planted_repeats, write_fasta
    monkeypatch.delenv("GT_TPU_DEVICE_EXTEND", raising=False)
    fna = tmp_path / "g.fna"
    write_fasta(planted_repeats(seed=11, length=50_000, repeats=6,
                                replen=(3_000, 8_000), wildcard_runs=2), fna)
    p = rse.SeedExtendParams(extension="greedy", seedlength=14,
                             minidentity=80, userdefinedleastlength=500)
    ref = [m.line() for m in rse.seed_extend(
        RefEncseq.from_files([str(fna)]), None, p)]
    enc = Encseq.from_files([str(fna)])
    fused = [m.line() for m in tse.seed_extend(
        enc, None, tse.params_from_reference(p), engine="fused")]
    tgb.reset_stats()
    # small waves: fewer seeds extended speculatively on the CPU
    got = [m.line() for m in tse.seed_extend(
        enc, None, tse.params_from_reference(p), device="cpu", wave=32)]
    assert got == fused == ref and ref
    assert tgb.stats["resident_lanes"] > 0
