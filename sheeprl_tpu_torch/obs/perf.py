"""Performance attribution plane: cost-model MFU, goodput ledger, step-time watchdog
(counterpart of ``sheeprl_tpu/obs/perf.py``).

1. **Cost models.** Each hot path registers the FLOPs and bytes of one call under the
   reference's name, and ``instrument`` counts its calls; ``PerfPlane.flush`` turns call
   deltas into ``Perf/{mfu,hbm_bw_util,achieved_flops_per_sec}`` with no device sync.
   The reference takes the numbers from XLA's ``cost_analysis()`` of the lowered step.
   The port counts them once per name and process, over one eager call: the warm-up
   call that a captured step (``utils/graphs.py::StepGraph``) runs before its capture,
   or the first call of an eager function. FLOPs come from
   ``torch.utils.flop_counter.FlopCounterMode``, which counts matrix products and
   convolutions (forward and backward) but no elementwise work; bytes from a
   ``TorchDispatchMode`` that sums the bytes of every aten op's tensor inputs and
   outputs, before any fusion, so they overstate what a fused kernel moves. The
   hand-written kernels (``ops/``) launch through ``ctypes`` and are seen by neither.
   Each replay of a captured step is one call.
2. **Goodput ledger** (a copy): one flush window's wall clock, from the drained
   ``Time/*`` timers and the capture seconds, into compute / env / transport /
   recompile / checkpoint / downtime / other; the fractions sum to 1.
3. **Step-time watchdog** (a copy): an EWMA step-time detector that fires one bounded
   profiler capture on a sustained regression after warm-up.

Peaks: ``PEAK_FLOPS`` and ``PEAK_HBM_BW`` hold GPU rows keyed by
``torch.cuda.get_device_name()``; the H100 row is its data sheet's dense bf16 FLOP/s and
HBM3 bandwidth. A CPU run keeps the reference's nominal figures. On a CUDA device with
no row, ``Perf/mfu`` and ``Perf/hbm_bw_util`` are left out, with one warning.

The registry is process-global and cleared by ``cli.run_algorithm`` after every run, so
multirun jobs do not share cost models.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import warnings
from typing import Any, Callable, Dict, Iterator, List, Mapping, MutableMapping, Optional, Tuple

__all__ = [
    "PEAK_FLOPS",
    "PEAK_HBM_BW",
    "PERF_REPORT_ENV_VAR",
    "GoodputLedger",
    "PerfPlane",
    "StepTimeWatchdog",
    "count_cost",
    "instrument",
    "peak_flops",
    "peak_hbm_bw",
    "perf_enabled",
    "record_call",
    "register_cost_model",
    "registered_cost_models",
    "report_path",
    "reset",
]

PERF_REPORT_ENV_VAR = "SHEEPRL_TPU_PERF_REPORT"

# Dense bf16 FLOP/s and HBM bytes/s per card (data-sheet figures), by device name.
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}
PEAK_HBM_BW = {"NVIDIA H100 80GB HBM3": 3.35e12}
# A CPU has no published bf16 matrix peak: the reference's nominal figures keep the
# gauges finite in CPU runs without claiming to be accurate.
_CPU_PEAK_FLOPS = 5e11
_CPU_PEAK_HBM_BW = 50e9

_warned_unknown: set = set()


def device_kind(device: Any = None) -> str:
    """``torch.cuda.get_device_name`` of a CUDA ``device``, ``"cpu"`` otherwise."""
    import torch

    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


def _lookup(table: Mapping[str, float], device: Any, cpu: float) -> Optional[float]:
    kind = device_kind(device)
    if kind == "cpu":
        return cpu
    for name, peak in table.items():
        if kind.startswith(name):
            return peak
    if kind not in _warned_unknown:
        _warned_unknown.add(kind)
        warnings.warn(f"obs.perf: no peak figures for {kind!r}; Perf/mfu and Perf/hbm_bw_util are left out")
    return None


def peak_flops(device: Any = None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of ``device`` (None for a CUDA device with no row)."""
    return _lookup(PEAK_FLOPS, device, _CPU_PEAK_FLOPS)


def peak_hbm_bw(device: Any = None) -> Optional[float]:
    """Peak memory bytes/s of ``device`` (None for a CUDA device with no row)."""
    return _lookup(PEAK_HBM_BW, device, _CPU_PEAK_HBM_BW)


# --------------------------------------------------------------------------- config


def _perf_cfg(cfg: Any) -> Mapping[str, Any]:
    if cfg is None:
        return {}
    try:
        obs = cfg.get("obs") if hasattr(cfg, "get") else getattr(cfg, "obs", None)
        if not obs:
            return {}
        perf = obs.get("perf") if hasattr(obs, "get") else getattr(obs, "perf", None)
        return perf or {}
    except Exception:
        return {}


def perf_enabled(cfg: Any) -> bool:
    """``obs.perf.enabled`` (True by default once an ``obs.perf`` section is composed; a
    config without one leaves the plane off)."""
    perf_cfg = _perf_cfg(cfg)
    if not perf_cfg:
        return False
    try:
        return bool(perf_cfg.get("enabled", True))
    except Exception:
        return True


# --------------------------------------------------------------------- cost registry


class _Entry:
    """One registered hot path: its cost model and a call counter (bumped without a
    lock: a lost increment only perturbs one window's gauge)."""

    __slots__ = ("name", "flops", "bytes_accessed", "info", "calls", "attempted")

    def __init__(self, name: str) -> None:
        self.name = name
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.info: Dict[str, Any] = {}
        self.calls = 0
        self.attempted = False


_lock = threading.Lock()
_registry: Dict[str, _Entry] = {}
# set while a PerfPlane with obs.perf.enabled lives: captured steps count their cost
_counting = False
_cost_seconds = 0.0  # host seconds spent counting cost models (added to start-up)


def _ensure_entry(name: str) -> _Entry:
    with _lock:
        entry = _registry.get(name)
        if entry is None:
            entry = _registry[name] = _Entry(name)
        return entry


def register_cost_model(name: str, flops: float, bytes_accessed: float = 0.0, **info: Any) -> None:
    """Record the cost model of one hot path (by name; a later call replaces it)."""
    entry = _ensure_entry(name)
    with _lock:
        entry.flops = float(flops or 0.0)
        entry.bytes_accessed = float(bytes_accessed or 0.0)
        entry.info.update(info)
        entry.attempted = True


def record_call(name: str, n: int = 1) -> None:
    """Add ``n`` calls of ``name``."""
    _ensure_entry(name).calls += n


def registered_cost_models() -> Dict[str, Dict[str, Any]]:
    """``{name: {flops, bytes_accessed, calls[, info]}}``."""
    with _lock:
        return {
            name: {"flops": e.flops, "bytes_accessed": e.bytes_accessed, "calls": e.calls, **({"info": dict(e.info)} if e.info else {})}
            for name, e in _registry.items()
        }


def cost_seconds() -> float:
    """Host seconds this process spent counting cost models."""
    return _cost_seconds


def counting() -> bool:
    """Whether a perf plane is on in this process."""
    return _counting


def set_counting(on: bool) -> None:
    global _counting
    _counting = bool(on)


def reset() -> None:
    """Clear the registry and stop counting (between multirun jobs, in tests)."""
    global _cost_seconds
    with _lock:
        _registry.clear()
        _cost_seconds = 0.0
    set_counting(False)


def should_count(name: Optional[str]) -> bool:
    """True once per ``name`` while the plane counts: the caller counts this call."""
    if not _counting or not name:
        return False
    entry = _ensure_entry(name)
    with _lock:
        if entry.attempted:
            return False
        entry.attempted = True
        return True


def _byte_counter():
    """A dispatch mode summing the bytes of every aten op's tensor inputs and outputs
    (made at first use: torch is imported when a cost is counted)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class ByteCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
            return out

    return ByteCounter()


@contextlib.contextmanager
def count_cost(name: str, **info: Any) -> Iterator[None]:
    """Count the FLOPs and bytes of the aten ops run inside, and register them as the
    cost model of one call of ``name``."""
    global _cost_seconds
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    flops = FlopCounterMode(display=False)
    nbytes = _byte_counter()
    with flops, nbytes:
        yield
    register_cost_model(name, float(flops.get_total_flops()), float(nbytes.bytes), **info)
    with _lock:
        _cost_seconds += time.perf_counter() - t0


def instrument(cfg: Any, name: str, fn: Callable[..., Any]) -> Callable[..., Any]:
    """Count every call of the hot path ``fn`` under ``name``; the identity when
    ``obs.perf.enabled`` is off. A captured step registers its cost model itself (give it
    ``name`` as its ``cost_name``); an eager ``fn`` is counted over its first call."""
    if not perf_enabled(cfg):
        return fn
    entry = _ensure_entry(name)

    def instrumented(*args: Any, **kwargs: Any) -> Any:
        entry.calls += 1
        if not entry.attempted and should_count(name):
            with count_cost(name):
                return fn(*args, **kwargs)
        return fn(*args, **kwargs)

    instrumented.__name__ = f"perf_instrument[{name}]"
    instrumented.__qualname__ = instrumented.__name__
    instrumented.__wrapped__ = fn
    return instrumented


# ------------------------------------------------------------------ goodput ledger

# First-present candidate lists: a block timed under two names counts once.
_COMPUTE_KEYS = ("Time/phase_dispatch", "Time/train_time", "Time/phase_train")
_ENV_KEYS = ("Time/phase_env_step", "Time/env_interaction_time", "Time/env_interaction", "Time/env_time")
_TRANSPORT_KEYS = ("Time/block_send", "Time/block_recv", "Time/queue_wait", "Time/phase_transport")
_CHECKPOINT_KEYS = ("Time/phase_checkpoint", "Time/checkpoint_time", "Time/phase_ckpt")

GOODPUT_CATEGORIES = ("compute", "env", "transport", "recompile", "checkpoint", "downtime", "other")


def _first_present(timers: Mapping[str, float], keys: Tuple[str, ...]) -> float:
    for key in keys:
        if key in timers:
            try:
                return max(0.0, float(timers[key]))
            except (TypeError, ValueError):
                return 0.0
    return 0.0


class GoodputLedger:
    """Wall clock into the goodput categories; the fractions sum to 1.0. When the
    classified seconds exceed the wall clock (overlapping timers), every category is
    scaled down so that the sum stays 1.0."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {c: 0.0 for c in GOODPUT_CATEGORIES}
        self.elapsed_total = 0.0

    def classify(self, timers: Mapping[str, float], elapsed_s: float, recompile_s: float = 0.0, downtime_s: float = 0.0) -> Dict[str, float]:
        seconds = {
            "compute": _first_present(timers, _COMPUTE_KEYS),
            "env": _first_present(timers, _ENV_KEYS),
            "transport": sum(_first_present(timers, (k,)) for k in _TRANSPORT_KEYS),
            "recompile": max(0.0, float(recompile_s or 0.0)),
            "checkpoint": _first_present(timers, _CHECKPOINT_KEYS),
            "downtime": max(0.0, float(downtime_s or 0.0)),
        }
        classified = sum(seconds.values())
        elapsed = float(elapsed_s or 0.0)
        if elapsed <= 0.0:
            elapsed = classified
        if elapsed <= 0.0:
            fractions = {c: 0.0 for c in GOODPUT_CATEGORIES}
            fractions["other"] = 1.0
            return fractions
        if classified > elapsed:
            scale = elapsed / classified
            seconds = {c: s * scale for c, s in seconds.items()}
            classified = elapsed
        seconds["other"] = elapsed - classified
        for category, value in seconds.items():
            self.totals[category] += value
        self.elapsed_total += elapsed
        return {c: seconds[c] / elapsed for c in GOODPUT_CATEGORIES}

    def fractions(self) -> Dict[str, float]:
        """Cumulative fractions over every classified window (sum to 1.0)."""
        if self.elapsed_total <= 0.0:
            out = {c: 0.0 for c in GOODPUT_CATEGORIES}
            out["other"] = 1.0
            return out
        return {c: self.totals[c] / self.elapsed_total for c in GOODPUT_CATEGORIES}

    def goodput(self) -> float:
        """The useful-work fraction: device compute and env stepping."""
        fractions = self.fractions()
        return fractions["compute"] + fractions["env"]


# -------------------------------------------------------------- step-time watchdog


class StepTimeWatchdog:
    """EWMA step-time regression detector with a bounded capture budget: ``observe(dt)``
    returns an event once per sustained degradation (EWMA above ``baseline * (1 +
    regress_pct)`` for ``sustain_steps`` observations), then stays silent until the EWMA
    recovers. The event's ``capture`` is True at most ``max_captures`` times."""

    def __init__(self, regress_pct: float = 0.25, warmup_steps: int = 20, sustain_steps: int = 5, alpha: float = 0.2, max_captures: int = 1) -> None:
        self.regress_pct = float(regress_pct)
        self.warmup_steps = max(1, int(warmup_steps))
        self.sustain_steps = max(1, int(sustain_steps))
        self.alpha = float(alpha)
        self.baseline: Optional[float] = None
        self.ewma: Optional[float] = None
        self.anomalies = 0
        self._observed = 0
        self._degraded_run = 0
        self._in_episode = False
        self._captures_left = max(0, int(max_captures))

    def observe(self, dt: float) -> Optional[Dict[str, float]]:
        dt = float(dt)
        if dt < 0.0:
            return None
        self._observed += 1
        if self.ewma is None:
            self.ewma = dt
        else:
            self.ewma = self.alpha * dt + (1.0 - self.alpha) * self.ewma
        if self._observed <= self.warmup_steps:
            self.baseline = self.ewma
            return None
        assert self.baseline is not None
        threshold = self.baseline * (1.0 + self.regress_pct)
        if self.ewma > threshold:
            self._degraded_run += 1
            if self._degraded_run >= self.sustain_steps and not self._in_episode:
                self._in_episode = True
                self.anomalies += 1
                capture = self._captures_left > 0
                if capture:
                    self._captures_left -= 1
                return {
                    "baseline_s": self.baseline,
                    "ewma_s": self.ewma,
                    "regress_pct": self.regress_pct,
                    "degradation": self.ewma / self.baseline - 1.0,
                    "capture": capture,
                }
        else:
            self._degraded_run = 0
            self._in_episode = False
        return None


# ----------------------------------------------------------------------- PerfPlane


class PerfPlane:
    """The per-process plane the training monitor owns: ``observe_step()`` per update
    feeds the watchdog, ``flush(metrics)`` folds ``Perf/*`` into a flush (reading the
    ``Time/*`` timers just drained into it), ``write_report(path)`` writes
    ``perf_report.json``. While it is enabled, captured steps count their cost models."""

    def __init__(self, cfg: Any = None, role: str = "learner", device: Any = None) -> None:
        perf_cfg = _perf_cfg(cfg)
        self.enabled = perf_enabled(cfg)
        self.role = role
        self.regress_pct = float(perf_cfg.get("regress_pct", 0.25) or 0.25)
        self.capture_updates = int(perf_cfg.get("capture_updates", 3) or 3)
        self.watchdog = StepTimeWatchdog(
            regress_pct=self.regress_pct,
            warmup_steps=int(perf_cfg.get("warmup_steps", 20) or 20),
            sustain_steps=int(perf_cfg.get("sustain_steps", 5) or 5),
            alpha=float(perf_cfg.get("ewma_alpha", 0.2) or 0.2),
            max_captures=int(perf_cfg.get("max_captures", 1) or 1),
        )
        self.ledger = GoodputLedger()
        self._device = device
        self._start = time.monotonic()
        self._last_flush = self._start
        self._last_step: Optional[float] = None
        self._last_calls: Dict[str, int] = {}
        self._flops_total = 0.0
        self._bytes_total = 0.0
        self.anomaly_events: List[Dict[str, float]] = []
        if self.enabled:
            set_counting(True)

    def observe_step(self) -> Optional[Dict[str, float]]:
        """The per-update heartbeat; returns a regression event when one fires."""
        if not self.enabled:
            return None
        now = time.monotonic()
        if self._last_step is None:
            self._last_step = now
            return None
        dt, self._last_step = now - self._last_step, now
        event = self.watchdog.observe(dt)
        if event is not None:
            self.anomaly_events.append(event)
        return event

    def _fold_calls(self) -> Tuple[float, float]:
        delta_flops = delta_bytes = 0.0
        for name, entry in registered_cost_models().items():
            delta_calls = entry["calls"] - self._last_calls.get(name, 0)
            self._last_calls[name] = entry["calls"]
            if delta_calls > 0:
                delta_flops += delta_calls * entry["flops"]
                delta_bytes += delta_calls * entry["bytes_accessed"]
        self._flops_total += delta_flops
        self._bytes_total += delta_bytes
        return delta_flops, delta_bytes

    def flush(self, metrics: MutableMapping[str, Any], recompile_s: float = 0.0, downtime_s: float = 0.0) -> None:
        """Fold ``Perf/*`` into ``metrics`` (which already holds the drained timers)."""
        if not self.enabled:
            return
        now = time.monotonic()
        elapsed, self._last_flush = now - self._last_flush, now
        delta_flops, delta_bytes = self._fold_calls()
        if elapsed > 0.0 and delta_flops > 0.0:
            achieved = delta_flops / elapsed
            metrics["Perf/achieved_flops_per_sec"] = achieved
            peak, bw = peak_flops(self._device), peak_hbm_bw(self._device)
            if peak:
                metrics["Perf/mfu"] = achieved / peak
            if bw:
                metrics["Perf/hbm_bw_util"] = (delta_bytes / elapsed) / bw
        fractions = self.ledger.classify(metrics, elapsed, recompile_s=recompile_s, downtime_s=downtime_s)
        metrics["Perf/goodput"] = fractions["compute"] + fractions["env"]
        for category, fraction in fractions.items():
            metrics[f"Perf/goodput_{category}"] = fraction
        metrics["Perf/anomalies"] = float(self.watchdog.anomalies)

    def report(self) -> Dict[str, Any]:
        self._fold_calls()
        elapsed = max(1e-9, time.monotonic() - self._start)
        peak, bw = peak_flops(self._device), peak_hbm_bw(self._device)
        achieved = self._flops_total / elapsed
        fractions = self.ledger.fractions()
        return {
            "role": self.role,
            "device_kind": device_kind(self._device),
            "peak_flops": peak,
            "peak_hbm_bw": bw,
            "elapsed_s": elapsed,
            "total_flops": self._flops_total,
            "total_bytes_accessed": self._bytes_total,
            "achieved_flops_per_sec": achieved,
            "mfu": achieved / peak if peak else None,
            "hbm_bw_util": (self._bytes_total / elapsed) / bw if bw else None,
            "goodput": fractions["compute"] + fractions["env"],
            "goodput_fractions": fractions,
            "anomalies": self.watchdog.anomalies,
            "anomaly_events": list(self.anomaly_events),
            "cost_models": registered_cost_models(),
            "cost_model_seconds": cost_seconds(),
        }

    def write_report(self, path: str) -> Optional[str]:
        """Write ``perf_report.json`` atomically; skipped when no cost model was ever
        registered and no anomaly fired."""
        if not self.enabled or not path:
            return None
        if not registered_cost_models() and not self.watchdog.anomalies:
            return None
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self.report(), f, indent=1, sort_keys=True)
            os.replace(tmp, path)
            return path
        except OSError:
            return None


def report_path(log_dir: Optional[str] = None) -> Optional[str]:
    """Where ``perf_report.json`` goes: the environment's override, then the run dir."""
    env = os.environ.get(PERF_REPORT_ENV_VAR)
    if env:
        return env
    if log_dir:
        return os.path.join(str(log_dir), "perf_report.json")
    return None
