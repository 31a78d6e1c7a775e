"""The port's tracer (genometools_torch/trace.py): off it records nothing
and hands out one shared no-op; it is on under enable() and while a
torch profiler records; parents follow each thread's own open spans;
stamps share the profiler's clock and no span becomes a profiler event;
and the index path and the seed loop give their span trees with the same
results whether tracing is on or off."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from genometools_torch import trace
from genometools_torch.core.encseq import FWD, Encseq
from genometools_torch.index.esa import build_esa
from genometools_torch.match import seed_extend as tse

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean():
    trace.enable(False)
    trace.clear()
    yield
    trace.enable(False)
    trace.clear()


def _by_id(recs):
    return {r.id: r for r in recs}


def _self_ns(rec, recs):
    """The span's duration less its children's (children do not
    overlap one another on one thread)."""
    kids = sum(r.end_ns - r.start_ns for r in recs if r.parent == rec.id)
    return rec.end_ns - rec.start_ns - kids


def test_off_records_nothing():
    a, b = trace.span("x", n=1), trace.span("y")
    assert a is trace.OFF and b is trace.OFF and not a
    with a as sp:
        sp.set(n=2)
    assert trace.records() == [] and trace.dropped() == 0


def test_enable_and_clear():
    trace.enable()
    with trace.span("x", n=1) as sp:
        assert sp
        sp.set(m=2)
    trace.enable(False)
    with trace.span("y"):
        pass
    (r,) = trace.records()
    assert r.name == "x" and r.attrs == {"n": 1, "m": 2}
    assert r.parent is None and r.thread == threading.get_ident()
    assert 0 <= r.end_ns - r.start_ns < 10 ** 9
    trace.clear()
    assert trace.records() == []


def test_on_while_the_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.span("x") is not trace.OFF
        with trace.span("x"):
            pass
    assert trace.span("y") is trace.OFF
    assert [r.name for r in trace.records()] == ["x"]


def test_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    trace.enable()
    for i in range(5):
        with trace.span("x", i=i):
            pass
    assert [r.attrs["i"] for r in trace.records()] == [0, 1, 2]
    assert trace.dropped() == 2
    trace.clear()
    assert trace.dropped() == 0


def test_parents_and_self_time():
    trace.enable()
    with trace.span("outer"):
        time.sleep(0.02)
        with trace.span("inner"):
            time.sleep(0.03)
        with trace.span("inner"):
            pass
    recs = trace.records()
    outer = next(r for r in recs if r.name == "outer")
    inner = [r for r in recs if r.name == "inner"]
    assert outer.parent is None and len(inner) == 2
    assert all(r.parent == outer.id for r in inner)
    assert all(outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
               for r in inner)
    assert _self_ns(outer, recs) >= 0.02e9
    assert outer.end_ns - outer.start_ns - _self_ns(outer, recs) >= 0.03e9
    assert _self_ns(inner[0], recs) >= 0.03e9


def test_parents_stay_per_thread():
    trace.enable()
    started, go = threading.Barrier(4), threading.Event()

    def work(k):
        with trace.span("job", k=k):
            started.wait(timeout=10)
            go.wait(timeout=10)
            with trace.span("step", k=k):
                pass

    threads = [threading.Thread(target=work, args=(k,)) for k in range(3)]
    with trace.span("main"):
        for t in threads:
            t.start()
        started.wait(timeout=10)
        go.set()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    recs = trace.records()
    ids = _by_id(recs)
    steps = [r for r in recs if r.name == "step"]
    assert len(steps) == 3
    for s in steps:
        job = ids[s.parent]
        assert job.name == "job" and job.attrs["k"] == s.attrs["k"]
        assert job.thread == s.thread and job.parent is None
    main = next(r for r in recs if r.name == "main")
    assert main.parent is None
    assert len({r.thread for r in steps} | {main.thread}) == 4


def test_profiler_clock_and_no_profiler_events():
    """Each annotation lies inside the span around it, on one clock, and
    the nearest start lies within 1 ms of its span's (a preempted
    thread only adds delay, so the nearest of five is the clock's)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):     # the first call's set-up
            pass
        for k in range(5):
            with trace.span("prog.outer", k=k):
                with record_function(f"annotated{k}"):
                    torch.ones(8).sum()
        with trace.span("prog.other"):
            torch.ones(8).sum()
    recs = trace.records()
    events = list(prof.profiler.kineto_results.events())
    assert not {e.name() for e in events} & {"prog.outer", "prog.other"}
    gaps = []
    for r in recs[:5]:
        (ann,) = [e for e in events
                  if e.name() == f"annotated{r.attrs['k']}"]
        start = int(ann.start_ns())
        end = start + int(ann.duration_ns())
        assert r.start_ns - 1_000_000 <= start <= end <= \
            r.end_ns + 1_000_000
        gaps.append(abs(start - r.start_ns))
    assert min(gaps) < 1_000_000, gaps
    assert recs[5].name == "prog.other" and \
        recs[5].start_ns >= recs[4].end_ns


def _reads(seed=5, nseq=6, n=900):
    """Random sequences that share planted repeats, so the seed loop
    finds matches on both strands."""
    rng = np.random.default_rng(seed)
    core = "".join(rng.choice(list("acgt"), 300))
    comp = str.maketrans("acgt", "tgca")
    parts = []
    for i in range(nseq):
        base = "".join(rng.choice(list("acgt"), n))
        rep = core if i % 2 else core[::-1].translate(comp)
        parts.append(base[:300] + rep + base[300:])
    return Encseq.from_string("|".join(parts))


def test_seed_loop_spans(spans):
    enc = _reads()
    params = tse.SeedExtendParams(seedlength=12, minidentity=85,
                                  extension="xdrop",
                                  userdefinedleastlength=20)
    trace.enable(False)
    off = [m.line() for m in tse.seed_extend(enc, None, params,
                                             device="cpu", wave=4)]
    assert trace.records() == []
    trace.enable()
    on = [m.line() for m in tse.seed_extend(enc, None, params,
                                            device="cpu", wave=4)]
    assert on == off and on
    recs = spans()
    ids = _by_id(recs)
    top = [r.name for r in recs if r.parent is None]
    assert top == ["seedext.seeds", "seedext.filter", "seedext.order",
                   "seedext.walk"] * 2
    assert [r.attrs["strand"] for r in recs if r.name == "seedext.seeds"] \
        == ["F", "P"]
    seeds = [r for r in recs if r.name == "seedext.seeds"]
    joins = [r for r in recs if r.name == "seedext.join"]
    assert [ids[j.parent] for j in joins] == seeds
    # the CPU run joins on the host: the card route counts candidates
    assert all(j.attrs == {"route": "native", "candidates": None,
                           "pairs": s.attrs["pairs"]} and j.attrs["pairs"]
               for j, s in zip(joins, seeds))
    walks = [r for r in recs if r.name == "seedext.walk"]
    assert sum(r.attrs["matches"] for r in walks) == len(on)
    waves = [r for r in recs if r.name == "seedext.wave"]
    assert len(waves) > 2
    assert all(ids[w.parent].name == "seedext.walk" for w in waves)
    assert all(w.attrs["candidates"] > 0 for w in waves)
    batches = [r for r in recs if r.name == "xdrop.batch"]
    assert batches and all(ids[b.parent].name == "seedext.wave"
                           for b in batches)
    for r in recs:
        if r.name in ("xdrop.k3", "xdrop.host"):
            assert ids[r.parent].name == "xdrop.batch"
    k3 = [r for r in recs if r.name == "xdrop.k3"]
    assert sum(r.attrs["lanes"] for r in k3) == \
        sum(r.attrs["lanes"] for r in batches)
    orders = [r for r in recs if r.name == "seedext.order"]
    filters = [r for r in recs if r.name == "seedext.filter"]
    assert all(f.attrs["segments"] > 0 for f in filters)
    assert all(0 < f.attrs["selected"] <= f.attrs["pairs"]
               and f.attrs["route"] == "native" for f in filters)
    assert all(o.attrs["candidates"] > 0 for o in orders)


def test_index_path_spans(spans, tmp_path):
    rng = np.random.default_rng(7)
    seqs = ["".join(rng.choice(list("acgtn"), 3000, p=[.24] * 4 + [.04]))
            for _ in range(3)]
    fasta = tmp_path / "g.fa"
    fasta.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    trace.enable(False)
    off = build_esa(Encseq.from_files([str(fasta)]), FWD, device="cpu")
    assert trace.records() == []
    trace.enable()
    enc = Encseq.from_files([str(fasta)])
    on = build_esa(enc, FWD, device="cpu")
    assert np.array_equal(on.suftab, off.suftab)
    assert np.array_equal(on.lcptab, off.lcptab)
    recs = spans()
    assert all(r.parent is None for r in recs)
    assert [r.name for r in recs] == [
        "encseq.parse", "encseq.md5", "esa.keys", "esa.upload",
        "esa.route", "esa.pack", "esa.bootstrap_sort", "esa.refine",
        "esa.sa_scatter", "esa.lcp_base", "esa.lcp_deep", "esa.fetch"]
    at = {r.name: r.attrs for r in recs}
    assert at["encseq.parse"] == {"bytes": fasta.stat().st_size,
                                  "sequences": 3}
    assert at["encseq.md5"] == {"sequences": 3}
    assert at["esa.keys"] == {"suffixes": enc.total_length + 1}
    assert at["esa.route"] == {"engine": "packed"}
    assert at["esa.fetch"]["bytes"] == 2 * 4 * (enc.total_length + 1)
    starts = [r.start_ns for r in recs]
    assert starts == sorted(starts)
