"""Device and host memory telemetry: ``Memory/*`` gauges (counterpart of
``sheeprl_tpu/obs/telemetry.py``).

On a CUDA run each poll reads the card: ``bytes_in_use`` and ``peak_bytes_in_use`` are
``torch.cuda.memory_stats(device)``'s ``allocated_bytes.all.current`` and ``.peak``,
``bytes_limit`` is the card's total memory from ``torch.cuda.mem_get_info``. A CPU run
has no device gauges: it reports ``Memory/host_peak_rss_bytes`` alone, as the reference
does on its CPU backend. Every poll adds the host's peak RSS, as the reference's does.
Polls are gated by a wall-clock interval.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence


def _host_rss_bytes() -> Dict[str, float]:
    try:
        import resource
        import sys

        usage = resource.getrusage(resource.RUSAGE_SELF)
        scale = 1 if sys.platform == "darwin" else 1024  # ru_maxrss: KiB on Linux
        return {"Memory/host_peak_rss_bytes": float(usage.ru_maxrss) * scale}
    except Exception:
        return {}


def cuda_memory_stats(device: Any) -> Dict[str, float]:
    """``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit`` of one card."""
    import torch

    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": float(total),
    }


class DeviceTelemetry:
    """An interval-gated poller; ``poll()`` returns ``{}`` between intervals, so callers
    merge it into the flush unconditionally. ``devices``: the CUDA devices to read (by
    default the current one when CUDA is initialised, none otherwise)."""

    def __init__(self, interval_s: float = 10.0, devices: Optional[Sequence[Any]] = None):
        self.interval_s = float(interval_s)
        self._devices = list(devices) if devices is not None else None
        self._last_poll = float("-inf")
        self.last: Dict[str, float] = {}

    def devices(self) -> Sequence[Any]:
        if self._devices is None:
            import torch

            self._devices = [torch.device("cuda", torch.cuda.current_device())] if torch.cuda.is_initialized() else []
        return self._devices

    def poll(self, force: bool = False) -> Dict[str, float]:
        now = time.monotonic()
        if not force and now - self._last_poll < self.interval_s:
            return {}
        self._last_poll = now
        out: Dict[str, float] = {}
        in_use_total, peak_max, saw = 0.0, 0.0, False
        for i, dev in enumerate(self.devices()):
            try:
                stats = cuda_memory_stats(dev)
            except Exception:
                continue
            saw = True
            for key, value in stats.items():
                out[f"Memory/{key}/dev{i}"] = value
            in_use_total += stats["bytes_in_use"]
            peak_max = max(peak_max, stats["peak_bytes_in_use"])
        if saw:
            out["Memory/bytes_in_use"] = in_use_total
            out["Memory/peak_bytes_in_use"] = peak_max
        out.update(_host_rss_bytes())
        self.last = out
        return out
