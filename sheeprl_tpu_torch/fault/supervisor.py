"""The supervisor's helpers that the Sebulba launcher uses (counterpart of
``sheeprl_tpu/fault/supervisor.py:72-116``): the run's root directory, the bounded
exponential backoff and the override strip. The supervisor itself (autoresume) is not
ported."""

from __future__ import annotations

from pathlib import Path
from typing import Any, List, Optional, Tuple


def run_dir_for(cfg: Any) -> Path:
    """The run's root directory (every ``version_*`` attempt lives under it)."""
    return Path(cfg.get("log_root", "logs")) / "runs" / str(cfg["root_dir"]) / str(cfg["run_name"])


def backoff_seconds(retries: int, base_s: float, max_s: float) -> float:
    """Exponential backoff for retry number ``retries`` (1-based): base * 2^(n-1)."""
    return min(float(base_s) * (2 ** max(retries - 1, 0)), float(max_s))


def _strip_override(overrides: List[str], key: str) -> Tuple[List[str], Optional[str]]:
    """``overrides`` without ``key=...``, and the value it had (None if absent)."""
    value = None
    kept = []
    for ov in overrides:
        if ov.startswith(f"{key}="):
            value = ov.split("=", 1)[1]
        else:
            kept.append(ov)
    return kept, value
