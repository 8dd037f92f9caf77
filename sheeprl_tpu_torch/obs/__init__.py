"""The training observability plane (counterpart of ``sheeprl_tpu/obs``):

* ``tracer``: the hierarchical span tracer, Chrome-trace export, per-span percentiles;
* ``telemetry``: ``Memory/*`` gauges from ``torch.cuda.memory_stats``;
* ``watchdog``: ``Compile/*`` gauges, a CUDA graph captured after warm-up as a recompile;
* ``perf``: cost-model MFU, the goodput ledger, the step-time watchdog, ``perf_report.json``;
* ``health``: the ``Health/*`` diagnostics computed inside the captured train steps;
* ``flight_recorder``: the bounded event ring dumped to ``<log_dir>/blackbox/`` on a crash;
* ``monitor``: ``TrainingMonitor``, which ties them into a training loop.

Not ported yet: the fleet plane (``fleet``, ``top``) and the blackbox's staged state and
replay (``replay_blackbox``).
"""

from sheeprl_tpu_torch.obs import flight_recorder, perf
from sheeprl_tpu_torch.obs.flight_recorder import FlightRecorder
from sheeprl_tpu_torch.obs.health import health_metrics, replay_age_metrics
from sheeprl_tpu_torch.obs.monitor import TrainingMonitor
from sheeprl_tpu_torch.obs.telemetry import DeviceTelemetry
from sheeprl_tpu_torch.obs.tracer import SpanTracer, get_active, set_active, span, trace_span
from sheeprl_tpu_torch.obs.watchdog import RecompileWarning, RecompileWatchdog

__all__ = [
    "TrainingMonitor",
    "DeviceTelemetry",
    "FlightRecorder",
    "SpanTracer",
    "RecompileWarning",
    "RecompileWatchdog",
    "flight_recorder",
    "perf",
    "get_active",
    "health_metrics",
    "replay_age_metrics",
    "set_active",
    "span",
    "trace_span",
]
