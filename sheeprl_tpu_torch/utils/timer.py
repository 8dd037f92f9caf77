"""Named wall-clock timers (counterpart of ``sheeprl_tpu/utils/timer.py``).

The reference keeps one registry per process (class attributes), so two runs in one
process, or a test after a run, read each other's times. Here each run makes its own
``Timer``; ``with timer("Time/env_interaction_time"): ...`` adds the block's seconds
under that name and ``to_dict()`` reads (and by default clears) them. A lock keeps
the sums whole where two threads time into one ``Timer`` (the decoupled entries' player
and learner).

Every timed block is also a span: with a tracer active (``obs/tracer.py``, on with
``obs.enabled``), each ``with timer(...)`` block of the loops begins and ends a span of
its name; with none, the hook is one global load.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator

from sheeprl_tpu_torch.obs import tracer as _tracer


class Timer:
    def __init__(self, disabled: bool = False):
        self.disabled = disabled
        self._registry: Dict[str, float] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        if self.disabled:
            yield
            return
        _tracer.maybe_begin(name)
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            with self._lock:
                self._registry[name] = self._registry.get(name, 0.0) + elapsed
            _tracer.maybe_end(name)

    def to_dict(self, reset: bool = True) -> Dict[str, float]:
        with self._lock:
            out = dict(self._registry)
            if reset:
                self._registry.clear()
        return out
