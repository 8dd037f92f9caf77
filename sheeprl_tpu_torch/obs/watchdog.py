"""Recapture watchdog: ``Compile/*`` gauges (counterpart of
``sheeprl_tpu/obs/watchdog.py``).

The reference counts XLA backend compiles through ``jax.monitoring`` and flags every one
after warm-up as a recompile. The port's compiled programs are CUDA graphs, captured at
setup (``utils/graphs.py``): ``total_compiles`` counts the graphs captured since the
watchdog was made, ``compile_seconds`` their warm-up and capture time, and a capture after
``mark_warm()`` is a recompile, which the monitor warns about with ``RecompileWarning``.
Kernels built at first use (``ops/_build.py``) are not counted: they build once per
process and are not programs of the step. The watchdog reads the counters when it is
polled; it registers no listener.
"""

from __future__ import annotations

import threading
from typing import Dict


def _graphs():
    from sheeprl_tpu_torch.utils import graphs  # at call time: graphs imports obs.perf

    return graphs


class RecompileWarning(UserWarning):
    """Warned when a step is captured again after warm-up."""


class RecompileWatchdog:
    def __init__(self):
        self._lock = threading.Lock()
        self._base_count = _graphs().capture_count()
        self._base_seconds = _graphs().capture_seconds()
        self._seen_count = self._base_count
        self._drained_seconds = self._base_seconds
        self._warm_count = None
        self._post_warmup = 0
        self._unseen = 0

    def _sync(self) -> None:
        count = _graphs().capture_count()
        if count > self._seen_count and self._warm_count is not None:
            self._post_warmup += count - self._seen_count
            self._unseen += count - self._seen_count
        self._seen_count = count

    def mark_warm(self) -> None:
        """Every capture so far was warm-up; any later one is a recapture."""
        with self._lock:
            self._sync()
            self._warm_count = self._seen_count

    @property
    def total_compiles(self) -> int:
        with self._lock:
            self._sync()
            return self._seen_count - self._base_count

    @property
    def recompiles(self) -> int:
        with self._lock:
            self._sync()
            return self._post_warmup

    def poll_new(self) -> int:
        """Captures after warm-up since the last poll."""
        with self._lock:
            self._sync()
            n, self._unseen = self._unseen, 0
        return n

    @property
    def compile_seconds(self) -> float:
        return _graphs().capture_seconds() - self._base_seconds

    def drain_compile_seconds(self) -> float:
        """Capture seconds since the last drain (the goodput ledger's recompile time)."""
        with self._lock:
            now = _graphs().capture_seconds()
            s, self._drained_seconds = now - self._drained_seconds, now
        return s

    def metrics(self) -> Dict[str, float]:
        return {
            "Compile/total_compiles": float(self.total_compiles),
            "Compile/recompiles": float(self.recompiles),
            "Compile/compile_seconds": float(self.compile_seconds),
        }

    def close(self) -> None:
        pass
