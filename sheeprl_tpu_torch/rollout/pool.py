"""``rollout_metrics`` (counterpart of ``sheeprl_tpu/rollout/pool.py::rollout_metrics``;
the env pool itself is not ported)."""

from __future__ import annotations

from typing import Any, Dict


def rollout_metrics(envs: Any) -> Dict[str, float]:
    """``Rollout/*`` counters of a vector env that keeps them, ``{}`` otherwise (every
    vector env of the port), so that a loop merges them with one unconditional line."""
    fn = getattr(envs, "rollout_metrics", None)
    return fn() if callable(fn) else {}
