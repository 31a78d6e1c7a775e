"""genometools_torch seed_extend (device wave path, CPU plain kernels)
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
    """Many small waves: mispredicted skips start new waves, and the
    lines still equal the reference's."""
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
    assert len(waves) > 2, waves


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


def test_fused_engine_is_the_reference_engine():
    from genometools_tpu.match import seed_extend as rse
    enc = _golden_enc("Atinsert.fna")
    p = rse.SeedExtendParams(minidentity=90, extension="greedy",
                             userdefinedleastlength=14)
    ref = [m.line() for m in rse.seed_extend(enc, None, p)]
    got = [m.line() for m in tse.seed_extend(
        enc, None, tse.params_from_reference(p), engine="fused")]
    assert got == ref and ref


@pytest.mark.parametrize("form", ["collect_extension_pool",
                                  "collect_extension_tasks"])
def test_extension_workload_matches_reference(form):
    from genometools_tpu.match import ext_workload as rew
    from genometools_tpu.match.seed_extend import SeedExtendParams
    enc = _golden_enc("Atinsert.fna")
    ref = getattr(rew, form)(enc, SeedExtendParams(extension="greedy"),
                             max_tasks=2000)
    got = getattr(tew, form)(enc, tse.SeedExtendParams(extension="greedy"),
                             max_tasks=2000)
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
