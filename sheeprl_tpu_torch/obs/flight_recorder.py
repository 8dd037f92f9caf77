"""Flight recorder: a bounded in-memory ring of structured training events, dumped as a
black box when a run crashes (counterpart of ``sheeprl_tpu/obs/flight_recorder.py``).

The recorder keeps the last few thousand events (span closures, metric flushes with
their ``Health/*`` snapshot, recompiles, perf regressions) in a lock-protected ring of
fixed size. When an exception escapes a train entry (``cli.run_algorithm``),
:func:`dump_active` writes ``<log_dir>/blackbox/``:

* ``events.jsonl``: the last ``keep_events`` events, one JSON object per line;
* ``meta.json``: the exception, the algorithm, the git SHA, the torch and CUDA
  versions and the device name, the config's fingerprint;
* ``config.yaml``: the run's composed config.

Deviations from the reference: ``meta.json`` carries ``torch_version``,
``cuda_version`` and ``device_name`` in place of ``jax_version``/``jaxlib_version``, and
the port stages no update state (no ``stage_step``/``arm_replay``, no replay of a dump):
the reference reaches a replayable dump only through strict mode, which the port does not
have yet. Every dump says ``staged_state: false``, as the reference's does when nothing
was staged.

Stdlib-only at import: the tracer feeds spans here.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import threading
import time
import traceback
import warnings
from collections import deque
from typing import Any, Dict, List, Optional

_ACTIVE: Optional["FlightRecorder"] = None


def get_active() -> Optional["FlightRecorder"]:
    return _ACTIVE


def install(recorder: Optional["FlightRecorder"]) -> Optional["FlightRecorder"]:
    """Install ``recorder`` as the process-global recorder; returns the previous one.
    ``install(None)`` clears it (``cli.run_algorithm`` does after every run)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = recorder
    return prev


def record_event(kind: str, **payload: Any) -> None:
    """Record on the active recorder; a no-op when none is installed."""
    if _ACTIVE is not None:
        _ACTIVE.record(kind, **payload)


def record_span(name: str, dur_ms: float, depth: int) -> None:
    """The tracer's span-closure hook."""
    if _ACTIVE is not None:
        _ACTIVE.record("span", name=name, dur_ms=round(float(dur_ms), 3), depth=depth)


def dump_active(reason: str, exc: Optional[BaseException] = None) -> Optional[str]:
    """Dump the active recorder's black box; returns the dump dir or None."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.dump(reason, exc)


def _jsonable(value: Any) -> Any:
    if isinstance(value, (str, int, bool)) or value is None:
        return value
    if isinstance(value, float):
        return value if value == value and value not in (float("inf"), float("-inf")) else repr(value)
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    item = getattr(value, "item", None)
    numel = getattr(value, "numel", None)
    size = numel() if callable(numel) else getattr(value, "size", None)
    if callable(item) and size == 1:
        try:
            return _jsonable(item())
        except Exception:
            pass
    return repr(value)


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=5, cwd=os.path.dirname(os.path.abspath(__file__))
        )
        return out.stdout.strip() or None if out.returncode == 0 else None
    except Exception:
        return None


def _config_fingerprint(cfg: Any) -> Optional[str]:
    try:
        blob = json.dumps(_jsonable(dict(cfg)), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()
    except Exception:
        return None


def _torch_meta() -> Dict[str, Any]:
    import torch

    meta: Dict[str, Any] = {"torch_version": torch.__version__, "cuda_version": torch.version.cuda, "device_name": None}
    if torch.cuda.is_available():
        meta["device_name"] = torch.cuda.get_device_name(torch.cuda.current_device())
    return meta


class FlightRecorder:
    """A bounded, thread-safe event ring and its black-box dump. ``capacity`` bounds the
    ring, ``keep_events`` the dump (the ring's tail)."""

    def __init__(self, log_dir: str, capacity: int = 4096, keep_events: int = 512, algo: Optional[str] = None, cfg: Any = None, rank: int = 0):
        self.log_dir = str(log_dir)
        self.capacity = max(int(capacity), 1)
        self.keep_events = max(int(keep_events), 1)
        self.algo = algo
        self.cfg = cfg
        self.rank = int(rank)
        self.total_recorded = 0
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._dumped: Optional[str] = None

    def record(self, kind: str, **payload: Any) -> None:
        event = {"ts": round(time.time(), 6), "kind": str(kind)}
        for k, v in payload.items():
            event[k] = _jsonable(v)
        with self._lock:
            self._events.append(event)
            self.total_recorded += 1

    def events(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._events)
        return out if last is None else out[-last:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def dump(self, reason: str, exc: Optional[BaseException] = None) -> Optional[str]:
        """Write the black box. The first dump wins (a crash can unwind through several
        layers that each try), and a failure inside the dump only warns: the dump must
        never mask the original exception."""
        if self._dumped is not None:
            return self._dumped
        out_dir = os.path.join(self.log_dir, "blackbox")
        try:
            os.makedirs(out_dir, exist_ok=True)
        except OSError as e:
            warnings.warn(f"flight recorder: cannot create {out_dir}: {e}")
            return None
        self._dumped = out_dir
        events_name = "events.jsonl" if self.rank == 0 else f"events_rank{self.rank}.jsonl"
        try:
            with open(os.path.join(out_dir, events_name), "w") as f:
                for event in self.events(last=self.keep_events):
                    f.write(json.dumps(event) + "\n")
        except Exception as e:
            warnings.warn(f"flight recorder: could not write events: {e}")
        if self.rank == 0:
            try:
                self._dump_meta(out_dir, reason, exc)
            except Exception as e:
                warnings.warn(f"flight recorder: could not write meta.json: {e}")
            try:
                if self.cfg is not None:
                    from sheeprl_tpu_torch.config.core import save_config

                    save_config(self.cfg, os.path.join(out_dir, "config.yaml"))
            except Exception as e:
                warnings.warn(f"flight recorder: could not save config: {e}")
        return out_dir

    def _dump_meta(self, out_dir: str, reason: str, exc: Optional[BaseException]) -> None:
        meta: Dict[str, Any] = {
            "reason": reason,
            "algo": self.algo,
            "time": time.time(),
            "git_sha": _git_sha(),
            "replay_target": None,
            "staged_state": False,
            "staged_updates": 0,
            "events_recorded": self.total_recorded,
            "events_dumped": min(self.total_recorded, self.keep_events, self.capacity),
            "config_fingerprint": _config_fingerprint(self.cfg) if self.cfg is not None else None,
        }
        try:
            from sheeprl_tpu_torch.fault.counters import fault_metrics

            meta["fault_counters"] = fault_metrics()
        except Exception:
            pass
        try:
            meta.update(_torch_meta())
        except Exception:
            pass
        if exc is not None:
            meta["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))[-8000:],
            }
        with open(os.path.join(out_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
