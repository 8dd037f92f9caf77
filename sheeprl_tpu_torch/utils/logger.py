"""Run directories and the scalar logger (counterpart of ``sheeprl_tpu/utils/logger.py``).

A run writes to ``<log_root>/runs/<root_dir>/<run_name>/version_N``, N one more than the
highest version already there. The port runs one process, so there is nothing to
broadcast. ``TensorBoardLogger`` writes scalars with ``torch.utils.tensorboard`` (the
card's host has tensorboard and no tensorboardX), or JSON lines where tensorboard is
missing. The MLflow logger is not ported.
"""

from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Any, Dict, Optional


def get_log_dir(cfg: Dict[str, Any], root_dir: Optional[str] = None, run_name: Optional[str] = None) -> str:
    root_dir = root_dir if root_dir is not None else cfg["root_dir"]
    run_name = run_name if run_name is not None else cfg["run_name"]
    base = pathlib.Path(cfg.get("log_root", "logs")) / "runs" / root_dir / run_name
    base.mkdir(parents=True, exist_ok=True)
    versions = [int(p.name.split("_")[1]) for p in base.glob("version_*") if p.name.split("_")[-1].isdigit()]
    log_dir = base / f"version_{max(versions) + 1 if versions else 0}"
    log_dir.mkdir(parents=True, exist_ok=True)
    return str(log_dir)


class TensorBoardLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._writer = None
        self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=log_dir)
        except ImportError:
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        if self._writer is not None:
            for k, v in metrics.items():
                self._writer.add_scalar(k, float(v), global_step=step)
        elif self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, "time": time.time(), **{k: float(v) for k, v in metrics.items()}}) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


def get_logger(cfg: Dict[str, Any], log_dir: str) -> Optional[TensorBoardLogger]:
    """None when ``metric.log_level`` is 0; raises for a logger the port lacks."""
    if cfg.get("metric", {}).get("log_level", 1) == 0:
        return None
    name = (cfg.get("logger") or {}).get("name", "tensorboard")
    if name != "tensorboard":
        raise NotImplementedError(f"logger.name={name!r} is not ported yet; the port logs to tensorboard")
    return TensorBoardLogger(log_dir)
