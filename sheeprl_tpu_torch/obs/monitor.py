"""``TrainingMonitor``: the observability plane wired into a training loop
(counterpart of ``sheeprl_tpu/obs/monitor.py``)::

    monitor = TrainingMonitor(cfg, log_dir, timer, device)   # after get_logger(...)
    for update in ...:
        monitor.advance()                                    # top of every update
        with monitor.phase("env_step"): ...
        monitor.log_metrics(logger, metrics, step)           # instead of logger.log_metrics
    monitor.close()                                          # before the loop's teardown

Per update, ``advance`` closes the previous update's profiler range and opens the next
(``torch.profiler.record_function("train")``, one slice per update in a profile), moves
the capture window (``obs.capture_steps=[N, M]``: a ``torch.profiler`` window over
updates N..M, the CUDA activities and the CPU ones at ``obs.host_tracer_level >= 1``,
written as a Chrome trace ``<log_dir>/profile/window_rank<r>_updates<N>-<M>.json``; the
step-time watchdog's auto-capture writes ``auto_rank<r>_updates<a>-<b>.json`` there; the
reference writes XProf's ``<log_dir>/xprof``), polls the memory telemetry and, after warm-up, warns on every graph
captured again. The span tracer is fed by the run's ``Timer`` blocks.

``phase(name)`` times ``Time/phase_<name>`` into the run's ``Timer`` (a span when the
tracer is on); ``log_metrics`` drains that ``Timer``, folds in the ``Fault/*`` counters and
the ``Perf/*`` gauges, records a ``metric_flush`` event on the flight recorder, and with
``obs.enabled`` adds span percentiles and the ``Memory/*`` and ``Compile/*`` gauges. The
flight recorder and the perf plane run whatever ``obs.enabled`` says, as in the
reference. Strict mode (``analysis.strict``) is not ported: the loops refuse it.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Any, Dict, Iterable, Optional

from sheeprl_tpu_torch.obs import flight_recorder as _flight_recorder
from sheeprl_tpu_torch.obs import perf as _perf
from sheeprl_tpu_torch.obs import tracer as _tracer
from sheeprl_tpu_torch.obs.telemetry import DeviceTelemetry
from sheeprl_tpu_torch.obs.tracer import SpanTracer
from sheeprl_tpu_torch.obs.watchdog import RecompileWarning, RecompileWatchdog

_UPDATE_SPAN = "Time/update"
_LOG_SPAN = "Time/log"


class TrainingMonitor:
    def __init__(
        self, cfg: Dict[str, Any], log_dir: str, timer=None, device: Any = None, rank: int = 0, phases: Optional[Iterable[str]] = None
    ):
        from sheeprl_tpu_torch.utils.timer import Timer

        obs_cfg = dict(cfg.get("obs", {}) or {})
        self.enabled: bool = bool(obs_cfg.get("enabled", False))
        self.log_dir = log_dir
        self.timer = timer if timer is not None else Timer()
        self.rank = int(rank)
        self._device = device
        self._phases = None if phases is None else frozenset(phases)
        self._updates = 0
        self._closed = False
        self.tracer: Optional[SpanTracer] = None
        self._telemetry: Optional[DeviceTelemetry] = None
        self._watchdog: Optional[RecompileWatchdog] = None
        # independent of obs.enabled: crash forensics on runs that never traced
        self.recorder = None
        if bool(obs_cfg.get("flight_recorder", True)):
            self.recorder = _flight_recorder.FlightRecorder(
                log_dir=log_dir,
                capacity=int(obs_cfg.get("flight_recorder_capacity", 4096)),
                keep_events=int(obs_cfg.get("flight_recorder_keep_events", 512)),
                algo=(cfg.get("algo", {}) or {}).get("name"),
                cfg=cfg,
                rank=self.rank,
            )
            _flight_recorder.install(self.recorder)
        self.perf = _perf.PerfPlane(cfg, device=device)
        self._capture = None
        self._capturing = False
        self._profiler = None
        self._annotation = None
        self._host_tracer_level = int(obs_cfg.get("host_tracer_level", 0))
        self._perf_capture_remaining = 0
        self._telemetry_latest: Dict[str, float] = {}
        if not self.enabled:
            return

        capture = obs_cfg.get("capture_steps")
        if capture:
            start, end = int(capture[0]), int(capture[1])
            if start < 1 or end < start:
                raise ValueError(f"obs.capture_steps must be [start>=1, end>=start]; got {capture!r}")
            self._capture = (start, end)
        self._annotations = bool(obs_cfg.get("xprof_annotations", True))
        self._warmup_updates = max(int(obs_cfg.get("warmup_updates", 1)), 0)
        self._prev_tracer = None
        if bool(obs_cfg.get("trace", True)):
            self.tracer = SpanTracer(rank=self.rank, max_events=int(obs_cfg.get("max_events", 100_000)))
            self._prev_tracer = _tracer.set_active(self.tracer)
        if bool(obs_cfg.get("telemetry", True)):
            cuda = device is not None and getattr(device, "type", str(device)) == "cuda"
            self._telemetry = DeviceTelemetry(interval_s=float(obs_cfg.get("telemetry_interval", 10.0)), devices=[device] if cuda else [])
        if bool(obs_cfg.get("watchdog", True)):
            self._watchdog = RecompileWatchdog()

    # ------------------------------------------------------------------ per update
    def advance(self, policy_step: Optional[int] = None) -> None:
        """Once at the top of every training update."""
        self._updates += 1
        event = self.perf.observe_step()
        if event is not None:
            _flight_recorder.record_event(
                "perf_regression",
                update=self._updates - 1,
                baseline_s=event["baseline_s"],
                ewma_s=event["ewma_s"],
                degradation=event["degradation"],
                capture=bool(event.get("capture")),
            )
        if not self.enabled:
            self._perf_capture_tick(event)
            return
        update = self._updates
        if self.tracer is not None:
            if update > 1:
                self.tracer.end(_UPDATE_SPAN)
            self.tracer.begin(_UPDATE_SPAN)
        # close the previous update's range before moving the window, open the next after
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None
        self._perf_capture_tick(event)
        if self._capture is not None:
            start, end = self._capture
            if update == start and not self._capturing:
                self._start_capture("window")
            elif update == end + 1 and self._capturing:
                self._stop_capture(end)
        if self._annotations:
            import torch

            self._annotation = torch.profiler.record_function("train")
            self._annotation.__enter__()
        if self._watchdog is not None:
            if update == self._warmup_updates + 1:
                self._watchdog.mark_warm()
            elif update > self._warmup_updates + 1:
                n = self._watchdog.poll_new()
                if n:
                    _flight_recorder.record_event("recompile", update=update - 1, count=n, total=self._watchdog.total_compiles)
                    warnings.warn(
                        f"{n} CUDA graph capture(s) after warm-up at update {update - 1} "
                        f"(total={self._watchdog.total_compiles}): a step was built again, which costs a warm-up "
                        "and a capture each time. Check Compile/recompiles and open a profiler window "
                        "(obs.capture_steps) around this update.",
                        RecompileWarning,
                        stacklevel=2,
                    )
        if self._telemetry is not None:
            polled = self._telemetry.poll()
            if polled:
                self._telemetry_latest = polled

    def _perf_capture_tick(self, event: Optional[Dict[str, float]]) -> None:
        """The step-time watchdog's bounded auto-capture window (obs.perf.capture_updates)."""
        if event is not None and event.get("capture") and not self._capturing:
            self._perf_capture_remaining = max(1, self.perf.capture_updates)
            self._start_capture("auto")
        elif self._perf_capture_remaining > 0:
            self._perf_capture_remaining -= 1
            if self._perf_capture_remaining <= 0 and self._capturing:
                self._stop_capture(self._updates - 1)

    # ------------------------------------------------------------------ metrics/logging
    def span(self, name: str):
        """An extra span: ``with monitor.span("Time/replay_ratio_wait"):``."""
        return _tracer._SpanContext(name, self.tracer)

    def phase(self, name: str):
        """``with monitor.phase("env_step"):`` adds the block's seconds to
        ``Time/phase_env_step`` in the run's timer (a span when the tracer is on). A
        monitor made with ``phases`` times those alone (the phases the reference's loop
        times) and passes through every other block."""
        if self._phases is not None and name not in self._phases:
            return contextlib.nullcontext()
        return self.timer(f"Time/phase_{name}")

    def metrics(self) -> Dict[str, float]:
        """Span percentiles and the memory and capture gauges, for the logger."""
        if not self.enabled:
            return {}
        out: Dict[str, float] = {}
        if self.tracer is not None:
            for name, stats in self.tracer.percentiles(reset=True).items():
                for k, v in stats.items():
                    out[f"{name}/{k}"] = v
        out.update(self._telemetry_latest)
        if self._watchdog is not None:
            out.update(self._watchdog.metrics())
        return out

    def log_metrics(self, logger, metrics: Dict[str, float], step: int) -> None:
        """Fold the timer, the ``Fault/*`` counters and the ``Perf/*`` gauges into the flush,
        record it on the flight recorder, and log it (inside a ``Time/log`` span)."""
        from sheeprl_tpu_torch.fault.counters import fault_metrics

        metrics.update(self.timer.to_dict(reset=True))
        metrics.update(fault_metrics())
        recompile_s = self._watchdog.drain_compile_seconds() if self._watchdog is not None else 0.0
        self.perf.flush(metrics, recompile_s=recompile_s)
        if _flight_recorder.get_active() is not None:
            snapshot = {k: metrics[k] for k in metrics if k.startswith(("Health/", "Loss/", "Compile/", "Rollout/", "Perf/"))}
            _flight_recorder.record_event("metric_flush", step=step, n_metrics=len(metrics), values=snapshot)
        if not self.enabled:
            if logger is not None:
                logger.log_metrics(metrics, step)
            return
        metrics.update(self.metrics())
        if logger is None:
            return
        if self.tracer is not None:
            self.tracer.begin(_LOG_SPAN)
            try:
                logger.log_metrics(metrics, step)
            finally:
                self.tracer.end(_LOG_SPAN)
        else:
            logger.log_metrics(metrics, step)

    # ------------------------------------------------------------------ capture window
    def profile_dir(self) -> str:
        return os.path.join(self.log_dir, "profile")

    def _start_capture(self, kind: str) -> None:
        """Open a ``torch.profiler`` window (``kind``: ``window``, the configured one, or
        ``auto``, the step-time watchdog's): the CUDA activities on a card (the CPU ones
        on a CPU run or at ``obs.host_tracer_level >= 1``)."""
        import torch

        activities = []
        cuda = self._device is not None and getattr(self._device, "type", str(self._device)) == "cuda"
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        if not cuda or self._host_tracer_level >= 1:
            activities.append(torch.profiler.ProfilerActivity.CPU)
        try:
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            self._capturing = True
            self._capture_name = f"{kind}_rank{self.rank}_updates{self._updates}"
        except Exception as e:  # a profiler already running: do not stop training
            self._profiler = None
            warnings.warn(f"obs.capture_steps: could not start the profiler: {e}")

    def _stop_capture(self, last: int) -> None:
        """Close the window, whose last update was ``last``, and write its trace."""
        if self._profiler is not None:
            try:
                self._profiler.stop()
                os.makedirs(self.profile_dir(), exist_ok=True)
                name = f"{self._capture_name}-{last}.json"
                self._profiler.export_chrome_trace(os.path.join(self.profile_dir(), name))
            except Exception as e:
                warnings.warn(f"obs.capture_steps: could not export the profiler trace: {e}")
            self._profiler = None
        self._capturing = False

    # ------------------------------------------------------------------ teardown
    def trace_path(self) -> str:
        name = "trace.json" if self.rank == 0 else f"trace_rank{self.rank}.json"
        return os.path.join(self.log_dir, name)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.enabled:
            if self._annotation is not None:
                self._annotation.__exit__(None, None, None)
                self._annotation = None
            if self._capturing:
                self._stop_capture(self._updates)
            if self._watchdog is not None:
                self._watchdog.close()
            if self.tracer is not None:
                self.tracer.end(_UPDATE_SPAN)
                try:
                    os.makedirs(self.log_dir, exist_ok=True)
                    self.tracer.export_chrome_trace(self.trace_path())
                except OSError as e:
                    warnings.warn(f"could not export Chrome trace: {e}")
                _tracer.set_active(self._prev_tracer)
        elif self._capturing:
            self._stop_capture(self._updates)
        path = _perf.report_path(self.log_dir)
        if path:
            self.perf.write_report(path)
        _perf.set_counting(False)
