"""A profiled slice of a run: the device's timeline beside the harness's
own spans, read from ``torch.profiler``'s trace.

:func:`profile` runs a callable under the profiler and parses the exported
trace (written to a temporary directory under ``TMPDIR`` and removed) into
a :class:`Slice`: every kernel, copy and memset on the device, and every
span the harness opened with :func:`span` (``record_function`` ranges,
which the trace puts on the device's clock). The busy time is the union of
the device's intervals, so overlapping streams are counted once and copies
are counted; the idle time is the rest of the slice's wall.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, List, NamedTuple, Optional, Tuple

PREFIX = "kbench."
SLICE = PREFIX + "slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Interval(NamedTuple):
    name: str
    start: float   # seconds on the trace's clock
    end: float
    cat: str = ""


class Slice(NamedTuple):
    start: float
    end: float
    device: List[Interval]   # kernels, copies, memsets inside the slice
    spans: List[Interval]    # the harness's spans, without the prefix

    @property
    def wall_s(self) -> float:
        return self.end - self.start

    def kernels(self, contains: str = "") -> List[Interval]:
        return [e for e in self.device
                if e.cat == "kernel" and contains in e.name]


@contextlib.contextmanager
def span(name: str, on: bool = True):
    """A named range in the trace when profiling (``on``), else nothing."""
    if not on:
        yield
        return
    import torch

    with torch.profiler.record_function(PREFIX + name):
        yield


def union(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, sorted."""
    out: List[List[float]] = []
    for s, e in sorted((max(i.start, lo), min(i.end, hi))
                       for i in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(sl: Slice) -> float:
    return sum(e - s for s, e in union(sl.device, sl.start, sl.end))


def idle_pct(sl: Slice) -> Optional[float]:
    """Share of the slice's wall with nothing on the device, in percent;
    None where the trace recorded no device activity."""
    if not sl.device or sl.wall_s <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(sl) / sl.wall_s)


def gaps(sl: Slice) -> List[Tuple[float, float]]:
    """The idle intervals of the device inside the slice."""
    busy = union(sl.device, sl.start, sl.end)
    out, t = [], sl.start
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if sl.end > t:
        out.append((t, sl.end))
    return out


def idle_by_span(sl: Slice, top: int = 10) -> List[List]:
    """Idle seconds of the device by the innermost harness span open on
    the host at each gap's middle (``"none"`` outside every span)."""
    spans = [s for s in sl.spans if s.name != SLICE[len(PREFIX):]]
    total = defaultdict(float)
    for s, e in gaps(sl):
        mid = 0.5 * (s + e)
        inner = [x for x in spans if x.start <= mid <= x.end]
        name = min(inner, key=lambda x: x.end - x.start).name \
            if inner else "none"
        total[name] += e - s
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            ][:top]


def top_ops(sl: Slice, top: int = 10, width: int = 120) -> List[List]:
    """Device seconds by operation name (kernels, copies, memsets)."""
    total = defaultdict(float)
    for e in sl.device:
        total[e.name[:width]] += e.end - e.start
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            ][:top]


def parse(events) -> Slice:
    """A :class:`Slice` from the trace's event list: the ``kbench.slice``
    span bounds it."""
    device, spans = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        start = float(ev["ts"]) * 1e-6
        end = start + float(ev["dur"]) * 1e-6
        name = str(ev.get("name", ""))
        if cat in DEVICE_CATS:
            device.append(Interval(name, start, end, cat))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            spans.append(Interval(name[len(PREFIX):], start, end, cat))
    bounds = [s for s in spans if s.name == SLICE[len(PREFIX):]]
    if not bounds:
        raise RuntimeError("the trace holds no kbench.slice span")
    lo, hi = bounds[0].start, bounds[0].end
    device = [e for e in device if e.end > lo and e.start < hi]
    return Slice(lo, hi, device, spans)


def profile(fn: Callable[[], object]) -> Slice:
    """Run ``fn`` under ``torch.profiler`` (host and device activity) inside
    the ``kbench.slice`` span and return the parsed :class:`Slice`."""
    import torch
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with span("slice"):
            fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="kbench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    return parse(events)
