"""``Fault/*`` counters: process-global, thread-safe, merged into every metric flush
(a copy of ``sheeprl_tpu/fault/counters.py``).

``TrainingMonitor.log_metrics`` folds :func:`fault_metrics` into each flush the same
way it folds the named-timer registry — independent of ``obs.enabled``, so a
preempted production run still shows its ``Fault/preemptions`` trail on the dashboard.
Counters that were never bumped are not reported (a healthy run's metric stream is
unchanged).

The supervisor seeds :data:`RESTARTS_ENV_VAR` into each child it relaunches so the
per-attempt processes report the *cumulative* restart count, not their own zero.

Stdlib-only at import.
"""

from __future__ import annotations

import os
import threading
from typing import Dict

#: Set by the supervisor on relaunched children: cumulative restarts so far.
RESTARTS_ENV_VAR = "SHEEPRL_TPU_FAULT_RESTARTS"

_lock = threading.Lock()
_counters: Dict[str, float] = {}


def _seed_from_env() -> None:
    restarts = os.environ.get(RESTARTS_ENV_VAR)
    if restarts:
        try:
            _counters["Fault/restarts"] = float(int(restarts))
        except ValueError:
            pass


_seed_from_env()


def bump(name: str, n: float = 1) -> None:
    """Increment ``Fault/<name>`` (pass the full key, e.g. ``"Fault/preemptions"``)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def fault_metrics() -> Dict[str, float]:
    """Snapshot of every counter that was ever bumped (empty for a healthy run)."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Tests only: drop all counters, then re-seed from the environment."""
    with _lock:
        _counters.clear()
        _seed_from_env()
