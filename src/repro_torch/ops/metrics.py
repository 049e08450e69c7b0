"""Host-side metrics: per-session counters, gauges, timings and windows.

A :class:`MetricsRegistry` is attached to every session ``Engine.open``
creates (disable with ``Engine(backend, metrics=False)`` or per session
with ``open(spec, metrics=False)``). Everything it records is sampled on
the host, outside every kernel launch:

  * no value becomes an operand of a launch and no runner is built for
    it, so a metrics-on session builds nothing more and gives the same
    bits as a metrics-off one;
  * chunk and step timings are dispatch wall times around the existing
    host calls (no ``torch.cuda.synchronize`` is inserted: a wait would
    change the latency being observed);
  * the build counter samples the runner's ``trace_count`` (runners and
    kernel libraries built or loaded) before and after each dispatch.

Recorded by the session (see :class:`repro_torch.core.session.Session`):

  counters  ``steps_total``, ``chunks_total``, ``traces`` (builds during a
            dispatch: 0 on a warm engine), ``snapshots_total``,
            ``restores_total``, ``swaps_total`` (spliced rows)
  timings   ``chunk_seconds``, ``step_seconds``, ``snapshot_seconds``,
            ``restore_seconds``, ``swap_seconds`` (count/total/min/max)
  gauges    ``chunk``, ``num_markets``

The registry is generic: any consumer may ``inc``/``observe``/``gauge``
more series. The serving gateway (:mod:`repro_torch.serve`) records:

  counters  ``frames_published_total``, ``frames_dropped_total``,
            ``sessions_opened_total``, ``sessions_closed_total``,
            ``reconnects_total``, ``checkpoints_saved_total``,
            ``journal_entries_total``, ``journal_compactions_total``,
            ``journal_entries_compacted_total``, ``recoveries_total``,
            ``recovery_attempts_total``, ``faults_coalesced_total``
  gauges    ``queue_depth.<client>``, ``clients_connected``,
            ``slots_attached``, ``checkpoint_writer_pending`` (0-2 by the
            lag bound), ``checkpoints_skipped``, ``degraded`` (0/1)
  windows   ``chunk_latency_seconds`` (dispatch to frames published),
            ``checkpoint_snapshot_seconds`` (the engine thread's share of
            a checkpoint: the synchronous device-to-host snapshot only),
            ``checkpoint_write_seconds`` (the writer thread's serialize,
            fsync and commit) and ``recovery_seconds``
"""
from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, List, Optional


class Aggregate:
    """count/total/min/max running aggregate of host-side observations."""

    __slots__ = ("count", "total", "min", "max")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def add(self, value: float) -> None:
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def summary(self) -> Dict[str, float]:
        mean = self.total / self.count if self.count else 0.0
        return {"count": self.count, "total": self.total, "mean": mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0}


class QuantileWindow:
    """Bounded sliding window of the last ``size`` observations with exact
    percentile reads — the latency-summary shape a serving layer needs
    (p50/p99 over *recent* traffic, not a run-lifetime mean).

    A ring buffer holds arrival order while a parallel sorted list supports
    O(log n) insert/remove, so :meth:`percentile` is an O(1) index into the
    sorted view. Memory is O(size) however long the gateway runs; ``size``
    defaults to 1024 observations.
    """

    __slots__ = ("size", "count", "_ring", "_next", "_sorted")

    def __init__(self, size: int = 1024) -> None:
        if size < 1:
            raise ValueError(f"window size must be >= 1, got {size}")
        self.size = int(size)
        self.count = 0            # lifetime observations (window may be full)
        self._ring: List[float] = []
        self._next = 0            # ring slot the next add overwrites
        self._sorted: List[float] = []

    def add(self, value: float) -> None:
        value = float(value)
        if len(self._ring) < self.size:
            self._ring.append(value)
        else:
            evicted = self._ring[self._next]
            self._sorted.pop(bisect.bisect_left(self._sorted, evicted))
            self._ring[self._next] = value
        self._next = (self._next + 1) % self.size
        bisect.insort(self._sorted, value)
        self.count += 1

    def __len__(self) -> int:
        return len(self._sorted)

    def percentile(self, q: float) -> float:
        """Exact nearest-rank percentile of the current window (q in
        [0, 100]); 0.0 on an empty window."""
        n = len(self._sorted)
        if not n:
            return 0.0
        rank = min(n - 1, max(0, int(round(q / 100.0 * (n - 1)))))
        return self._sorted[rank]

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "window": len(self._sorted),
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99),
                "min": self._sorted[0] if self._sorted else 0.0,
                "max": self._sorted[-1] if self._sorted else 0.0}


class MetricsRegistry:
    """Per-session metrics: counters, gauges, timing aggregates, and
    bounded-window quantile summaries.

    Thread-safe (one lock around the tiny dict updates) so a streaming
    consumer thread may read :meth:`snapshot` while the session advances.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, Any] = {}
        self._timings: Dict[str, Aggregate] = {}
        self._windows: Dict[str, QuantileWindow] = {}

    # ---- write side (host only) ----
    def inc(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def gauge(self, name: str, value: Any) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            agg = self._timings.get(name)
            if agg is None:
                agg = self._timings[name] = Aggregate()
            agg.add(value)

    def observe_window(self, name: str, value: float,
                       size: int = 1024) -> None:
        """Record into a bounded :class:`QuantileWindow` series (created on
        first use with ``size``; later calls ignore ``size``)."""
        with self._lock:
            win = self._windows.get(name)
            if win is None:
                win = self._windows[name] = QuantileWindow(size)
            win.add(value)

    # ---- read side ----
    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def gauge_value(self, name: str, default: Any = None) -> Any:
        with self._lock:
            return self._gauges.get(name, default)

    def window(self, name: str) -> Optional[QuantileWindow]:
        with self._lock:
            return self._windows.get(name)

    def steps_per_s(self) -> float:
        """Derived throughput: steps dispatched per second of chunk wall
        time (dispatch-side; see module docstring for the async caveat)."""
        with self._lock:
            steps = self._counters.get("steps_total", 0)
            agg = self._timings.get("chunk_seconds")
            secs = agg.total if agg is not None else 0.0
        return steps / secs if secs > 0 else 0.0

    def snapshot(self) -> Dict[str, Any]:
        """Plain-python view: {'counters', 'gauges', 'timings', 'windows',
        'derived'}."""
        with self._lock:
            out = {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timings": {k: v.summary() for k, v in self._timings.items()},
                "windows": {k: v.summary() for k, v in self._windows.items()},
            }
        out["derived"] = {"steps_per_s": self.steps_per_s()}
        return out
