"""The rate, percentile and sampling arithmetic over a synthetic
window."""

import numpy as np
import pytest

from portbench import harness


def _metric(name, run):
    return harness.load_part("metrics", name).read(run)


def test_percentile_matches_numpy():
    rng = np.random.default_rng(0)
    for n in (1, 2, 5, 20, 401):
        x = rng.exponential(size=n).tolist()
        for q in (0, 50, 95, 100):
            assert harness.percentile(x, q) == pytest.approx(
                float(np.percentile(x, q)), rel=1e-12)


def test_rates_and_tail_over_all_jobs():
    # 5 jobs back to back from t = 10: durations 1, 2, 1, 1, 5
    ends = [11.0, 13.0, 14.0, 15.0, 20.0]
    starts = [10.0] + ends[:-1]
    jobs = [(s, e, {"suffixes": 100, "read_bp": 7, "index_s": [e - s]})
            for s, e in zip(starts, ends)]
    run = harness.Run(setup_s=3.5, window_start=10.0, jobs=jobs, spans=[
        ("esa.build", i, s, s + 0.5) for i, (s, _, _) in enumerate(jobs)],
        counters={"xdrop_lanes": 540, "matches": 9}, peak_bytes=3 << 30)
    assert _metric("suffixes_per_s", run) == pytest.approx(500 / 10.0)
    assert _metric("read_bp_per_s", run) == pytest.approx(35 / 10.0)
    # sorted 1, 1, 1, 2, 5: rank 3.8 -> 2 + 0.8 * 3
    assert _metric("index_s_p95", run) == pytest.approx(4.4)
    assert _metric("setup_s", run) == 3.5
    assert _metric("index.esa_build_ms", run) == pytest.approx(500.0)
    assert _metric("index.encseq_read_ms", run) is None
    assert _metric("seedext.lanes_per_match", run) == 60.0
    assert _metric("index.dtoh_ms", run) is None       # not traced


@pytest.mark.parametrize("typed", [True, False])
def test_trace_reduction(typed):
    from portbench import trace

    class Event:
        """A kineto event as torch 2.11 gives it: no activity type."""

        def __init__(self, name, dev, start, dur, act="kernel"):
            self._n, self._d, self._s, self._u, self._a = \
                name, dev, start, dur, act

        def name(self):
            return self._n

        def device_type(self):
            return self._d

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._u

    class Typed(Event):
        def activity_type(self):
            return self._a

    E = Typed if typed else Event

    ms = 1_000_000
    ev = [E("portbench/window", "DeviceType.CPU", 0, 100 * ms,
            "user_annotation"),
          E("portbench/esa.build/0", "DeviceType.CPU", 10 * ms, 40 * ms,
            "user_annotation"),
          E("portbench/esa.build/0", "DeviceType.CUDA", 10 * ms, 40 * ms,
            "gpu_user_annotation"),
          E("sort_kernel", "DeviceType.CUDA", 12 * ms, 10 * ms),
          E("scan_kernel", "DeviceType.CUDA", 20 * ms, 10 * ms),
          E("Memcpy DtoH (Device -> Pageable)", "DeviceType.CUDA",
            40 * ms, 5 * ms, "gpu_memcpy"),
          E("aten::sort", "DeviceType.CPU", 11 * ms, 3 * ms, "cpu_op")]
    t = trace.reduce(ev)
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(0.023)          # 12-30 and 40-45
    (span,) = t.spans
    assert span.kernel_s == pytest.approx(0.020)
    assert span.dtoh_s == pytest.approx(0.005)
    gaps = sorted(t.gaps, key=lambda g: -g[1])
    assert gaps[0] == ("between_jobs", pytest.approx(0.055))
    assert ("esa.build", pytest.approx(0.010)) in gaps
    run = harness.Run(1.0, 0.0, [(0.0, 0.1, {"suffixes": 1_000_000})],
                      [], {}, 0, t)
    assert _metric("index.dtoh_ms", run) == pytest.approx(5.0)
    assert _metric("index.device_idle_pct", run) == pytest.approx(77.0)
    least = 1_000_000 * 9 / 3.35e12
    assert _metric("index.suffix_roofline", run) == pytest.approx(
        100 * least / 0.020)
    b = trace.breakdown(t)
    assert b["device_ops"][0][0] in ("sort_kernel", "scan_kernel")
    assert len(b["idle_gaps"]) <= 10


def test_reservoir_is_uniform_and_seeded():
    counts = np.zeros(20)
    for s in range(400):
        r = harness.Reservoir(4, harness.seeded(s, "reservoir"))
        for i in range(20):
            r.offer(i, i)
        for k, _ in r.items():
            counts[k] += 1
        assert len(r.items()) == 4
    assert counts.min() > 40 and counts.max() < 120     # 80 expected
    a = harness.Reservoir(3, harness.seeded(1, "x"))
    b = harness.Reservoir(3, harness.seeded(1, "x"))
    for i in range(50):
        a.offer(i, i)
        b.offer(i, i)
    assert a.items() == b.items()


def test_large_seed():
    a = harness.seeded(2 ** 31 + 12345, "inputs").integers(0, 1 << 30)
    b = harness.seeded(2 ** 31 + 12345, "inputs").integers(0, 1 << 30)
    assert a == b
