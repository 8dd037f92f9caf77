"""Hierarchical span tracer: Chrome-trace/Perfetto export and per-span latency
percentiles (counterpart of ``sheeprl_tpu/obs/tracer.py``).

Spans nest through a per-thread stack, so a ``with`` block inside another shows as a
child slice in Perfetto; every completed span also feeds a ``HistogramMetric``, so
p50/p95/p99 latencies flow into the metric flush. The module-level *active* tracer has
a ``None`` fast path: instrumentation left in hot loops costs one global load when
tracing is off. ``utils/timer.py::Timer`` begins and ends a span on the active tracer,
so every ``with timer(...)`` block of the loops is a span.

One deviation from the reference: a span's Chrome-trace track (``tid``) is a number the
tracer gives each thread the first time it records, never reused. The reference keys
tracks by ``threading.get_ident()``, which CPython hands out again once a thread has
ended, so two threads of one run could share a track.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from sheeprl_tpu_torch.obs import flight_recorder as _flight_recorder
from sheeprl_tpu_torch.utils.metric import HistogramMetric

# (name, ts_us, dur_us, tid, depth)
_Event = Tuple[str, float, float, int, int]

_ACTIVE: Optional["SpanTracer"] = None


def get_active() -> Optional["SpanTracer"]:
    return _ACTIVE


def set_active(tracer: Optional["SpanTracer"]) -> Optional["SpanTracer"]:
    """Install ``tracer`` as the process-global tracer; returns the previous one."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    return prev


def maybe_begin(name: str) -> None:
    """The timer's hook: a no-op unless a tracer is active."""
    if _ACTIVE is not None:
        _ACTIVE.begin(name)


def maybe_end(name: str) -> None:
    if _ACTIVE is not None:
        _ACTIVE.end(name)


class _SpanContext:
    """The context manager that ``SpanTracer.span`` and the module's ``span`` hand out."""

    __slots__ = ("_name", "_tracer")

    def __init__(self, name: str, tracer: Optional["SpanTracer"]):
        self._name = name
        self._tracer = tracer

    def __enter__(self):
        tracer = self._tracer if self._tracer is not None else _ACTIVE
        if tracer is not None:
            tracer.begin(self._name)
        return self

    def __exit__(self, *exc):
        tracer = self._tracer if self._tracer is not None else _ACTIVE
        if tracer is not None:
            tracer.end(self._name)
        return False


def span(name: str) -> _SpanContext:
    """``with span("Time/phase"):`` records on whichever tracer is active at entry."""
    return _SpanContext(name, None)


def trace_span(name: str) -> Callable:
    """Decorator form: the wrapped call becomes one span (a no-op when tracing is off)."""

    def deco(fn: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            if _ACTIVE is None:
                return fn(*args, **kwargs)
            _ACTIVE.begin(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _ACTIVE.end(name)

        wrapper.__name__ = getattr(fn, "__name__", "wrapped")
        wrapper.__doc__ = fn.__doc__
        wrapper.__wrapped__ = fn
        return wrapper

    return deco


class SpanTracer:
    """Nested spans into a bounded Chrome-trace event list and per-name latency
    histograms. ``rank`` becomes the Chrome trace's ``pid``."""

    def __init__(self, rank: int = 0, max_events: int = 100_000):
        self.rank = int(rank)
        self.max_events = int(max_events)
        self.dropped_events = 0
        self._events: List[_Event] = []
        self._histograms: Dict[str, HistogramMetric] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._track_ids = itertools.count(1)
        self._origin = time.perf_counter()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _track(self) -> int:
        """This thread's track: assigned at its first span, never given to another."""
        tid = getattr(self._local, "track", None)
        if tid is None:
            tid = self._local.track = next(self._track_ids)
        return tid

    def begin(self, name: str) -> None:
        self._stack().append((name, time.perf_counter()))

    def end(self, name: str) -> None:
        now = time.perf_counter()
        stack = self._stack()
        if not stack:
            return  # an end without its begin: the tracer was activated mid-span
        # unwind to the matching name, so that an unbalanced block cannot skew the depth
        while stack:
            top_name, start = stack.pop()
            if top_name == name:
                break
        else:
            return
        dur_us = (now - start) * 1e6
        ts_us = (start - self._origin) * 1e6
        depth = len(stack)
        tid = self._track()
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = self._histograms[name] = HistogramMetric()
            hist.update(dur_us / 1e3)  # milliseconds
            if len(self._events) < self.max_events:
                self._events.append((name, ts_us, dur_us, tid, depth))
            else:
                self.dropped_events += 1
        _flight_recorder.record_span(name, dur_us / 1e3, depth)

    def percentiles(self, reset: bool = True) -> Dict[str, Dict[str, float]]:
        """Per span ``{name: {p50, p95, p99, mean, count}}`` in milliseconds."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for name, hist in self._histograms.items():
                v = hist.compute()
                if v:
                    out[name] = v
                if reset:
                    hist.reset()
        return out

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome Trace Event Format dict (Perfetto, chrome://tracing)."""
        with self._lock:
            events = list(self._events)
        tids = sorted({e[3] for e in events})
        trace_events: List[Dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": self.rank, "args": {"name": f"rank{self.rank}"}}
        ]
        for tid in tids:
            trace_events.append({"name": "thread_name", "ph": "M", "pid": self.rank, "tid": tid, "args": {"name": f"thread-{tid}"}})
        for name, ts_us, dur_us, tid, depth in events:
            trace_events.append({
                "name": name,
                "cat": "sheeprl_tpu",
                "ph": "X",
                "ts": round(ts_us, 3),
                "dur": round(dur_us, 3),
                "pid": self.rank,
                "tid": tid,
                "args": {"depth": depth},
            })
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._histograms.clear()
            self.dropped_events = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)
