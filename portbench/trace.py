"""The traced run: torch.profiler over the measured window, reduced to
what the per-layer readers and the breakdown take.

Harness spans are profiler annotations named ``portbench/<span>/<job>``
(the window itself is ``portbench/window``), so spans and device
operations share the profiler's clock. An operation on the device is
any event whose device is not the CPU, other than an annotation's
mirror on the device's timeline.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

PREFIX = "portbench/"


@dataclass
class Span:
    name: str
    job: int
    start: int           # ns, the profiler's clock
    end: int
    kernel_s: float = 0.0
    dtoh_s: float = 0.0


@dataclass
class Trace:
    window_s: float
    busy_s: float
    spans: list = field(default_factory=list)
    ops: dict = field(default_factory=dict)     # name -> device seconds
    gaps: list = field(default_factory=list)    # (span name, seconds)


def _kind(e) -> str:
    # torch 2.11's kineto events carry no activity type: then the name
    # alone tells copies, sets and annotations from kernels
    act = str(e.activity_type()).lower() if hasattr(e, "activity_type") \
        else ""
    name = e.name()
    if "annotation" in act or name.startswith(PREFIX):
        return "annotation"
    if "memcpy" in act or name.startswith("Memcpy"):
        return "copy"
    if "memset" in act or name.startswith("Memset"):
        return "memset"
    return "kernel"


def _is_dtoh(name: str) -> bool:
    return "DtoH" in name or "Device -> Host" in name or \
        "Device -> Pageable" in name or "Device -> Pinned" in name


def reduce(events) -> Trace:
    """A Trace from the profiler's events (kineto events: name(),
    device_type(), start and duration)."""
    spans, window, dev = [], None, []
    for e in events:
        name = e.name()
        on_cpu = "CPU" in str(e.device_type())
        kind = _kind(e)
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        if kind == "annotation":
            if on_cpu and name == PREFIX + "window":
                window = (start, end)
            elif on_cpu and name.startswith(PREFIX):
                span, _, job = name[len(PREFIX):].rpartition("/")
                spans.append(Span(span, int(job), start, end))
        elif not on_cpu:
            dev.append((start, end, kind, name))
    if window is None:
        raise RuntimeError("the trace holds no window annotation")
    w0, w1 = window
    dev = sorted((max(s, w0), min(e, w1), k, n) for s, e, k, n in dev
                 if e > w0 and s < w1)
    spans.sort(key=lambda s: s.start)
    starts = [s.start for s in spans]
    ops: dict = {}
    busy, cur0, cur1, gaps = 0, w0, w0, []

    def gap(a, b):
        if b > a:
            i = bisect.bisect_right(starts, (a + b) // 2) - 1
            inside = i >= 0 and spans[i].end >= (a + b) // 2
            gaps.append((spans[i].name if inside else "between_jobs",
                         (b - a) / 1e9))

    for s, e, kind, name in dev:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= spans[i].end:
            if kind == "kernel":
                spans[i].kernel_s += (e - s) / 1e9
            elif kind == "copy" and _is_dtoh(name):
                spans[i].dtoh_s += (e - s) / 1e9
        if s > cur1:
            busy += cur1 - cur0
            gap(cur1, s)
            cur0, cur1 = s, e
        else:
            cur1 = max(cur1, e)
    busy += cur1 - cur0
    gap(cur1, w1)
    return Trace((w1 - w0) / 1e9, busy / 1e9, spans, ops, gaps)


class Profiled:
    """torch.profiler over the CPU and, with cuda, the card; `trace()`
    after exit."""

    def __init__(self, cuda: bool = True):
        from torch.profiler import ProfilerActivity, profile
        self._cuda = cuda
        self._prof = profile(activities=[ProfilerActivity.CPU] +
                             ([ProfilerActivity.CUDA] if cuda else []))

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._cuda:
            import torch
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        return False

    def trace(self) -> Trace:
        return reduce(self._prof.profiler.kineto_results.events())


def breakdown(t: Trace) -> dict:
    """The ten device operations that took most time, and the ten
    longest idle gaps, each named by the harness span that was open."""
    ops = sorted(t.ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(t.gaps, key=lambda g: -g[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
