"""Run directories (counterpart of ``sheeprl_tpu/utils/logger.py``; ``get_log_dir`` only,
the scalar logger comes with the training slice).

A run writes to ``<log_root>/runs/<root_dir>/<run_name>/version_N``, N one more than the
highest version already there. The port runs one process, so there is nothing to
broadcast.
"""

from __future__ import annotations

import pathlib
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
