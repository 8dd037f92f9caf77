"""Metric aggregation (counterpart of ``sheeprl_tpu/utils/metric.py``).

Host-side accumulators fed with Python floats or 0-d tensors; ``compute()`` returns the
means and drops metrics that saw nothing finite. The port runs one process, so
``make_aggregator`` always returns a ``MetricAggregator``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Optional

import numpy as np


class MeanMetric:
    def __init__(self):
        self._sum = 0.0
        self._count = 0

    def update(self, value: Any) -> None:
        # non-finite values are dropped as they come, so one NaN cannot poison the window
        arr = np.asarray(value, dtype=np.float64).reshape(-1)
        finite = arr[np.isfinite(arr)]
        self._sum += float(finite.sum())
        self._count += int(finite.size)

    def compute(self) -> float:
        return float("nan") if self._count == 0 else self._sum / self._count

    def reset(self) -> None:
        self._sum = 0.0
        self._count = 0


class SumMetric(MeanMetric):
    def compute(self) -> float:
        return self._sum


class LastMetric(MeanMetric):
    def __init__(self):
        super().__init__()
        self._last = float("nan")

    def update(self, value: Any) -> None:
        self._last = float(np.asarray(value).reshape(-1)[-1])
        self._count += 1

    def compute(self) -> float:
        return self._last


_METRIC_TYPES = {"mean": MeanMetric, "sum": SumMetric, "last": LastMetric}


class MetricAggregator:
    """Named metrics; ``disabled`` (``metric.log_level=0``) makes every call a no-op."""

    def __init__(self, metrics: Optional[Dict[str, Any]] = None, disabled: bool = False):
        self.disabled = disabled
        self.metrics: Dict[str, Any] = {}
        for name, spec in (metrics or {}).items():
            self.add(name, spec)

    def add(self, name: str, metric: Any = "mean") -> None:
        if isinstance(metric, str):
            metric = _METRIC_TYPES[metric]()
        elif isinstance(metric, dict):
            metric = _METRIC_TYPES[metric.get("type", "mean")]()
        self.metrics[name] = metric

    def update(self, name: str, value: Any) -> None:
        if self.disabled:
            return
        if name not in self.metrics:
            self.add(name)
        if hasattr(value, "item") and getattr(value, "numel", lambda: getattr(value, "size", 1))() == 1:
            value = value.item()
        self.metrics[name].update(value)

    def __contains__(self, name: str) -> bool:
        return name in self.metrics

    def keep(self, keys: Iterable[str]) -> None:
        """Prune to a whitelist."""
        keys = set(keys)
        self.metrics = {k: v for k, v in self.metrics.items() if k in keys}

    def compute(self) -> Dict[str, float]:
        if self.disabled:
            return {}
        out: Dict[str, float] = {}
        for name, metric in self.metrics.items():
            v = metric.compute()
            if v is None or (isinstance(v, float) and math.isnan(v)):
                continue
            out[name] = v
        return out

    def reset(self) -> None:
        for m in self.metrics.values():
            m.reset()


def make_aggregator(metrics: Optional[Dict[str, Any]] = None, disabled: bool = False) -> MetricAggregator:
    return MetricAggregator(metrics, disabled)


def record_episode_stats(aggregator: MetricAggregator, info: Dict[str, Any]) -> None:
    """Feed ``RecordEpisodeStatistics`` vector-env info into the aggregator: from
    ``info["final_info"]["episode"]`` (same-step autoreset) or ``info["episode"]``."""
    src = None
    if "final_info" in info and isinstance(info["final_info"], dict) and "episode" in info["final_info"]:
        src = info["final_info"]
    elif "episode" in info:
        src = info
    if src is None:
        return
    ep = src["episode"]
    mask = np.asarray(src.get("_episode", np.ones(np.asarray(ep["r"]).shape, dtype=bool)))
    for r, length in zip(np.asarray(ep["r"])[mask], np.asarray(ep["l"])[mask]):
        aggregator.update("Rewards/rew_avg", float(r))
        aggregator.update("Game/ep_len_avg", float(length))
