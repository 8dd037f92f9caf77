"""CLI entry points (counterpart of ``sheeprl_tpu/cli.py``). Ported so far: evaluation.

``python -m sheeprl_tpu_torch.eval checkpoint_path=<run>/checkpoints/ckpt_N [overrides]``
loads the run's saved ``config.yaml``, applies the overrides, and calls the algorithm's
registered evaluation entry on ``device`` (``cuda`` unless ``device=cpu`` is given).
"""

from __future__ import annotations

import datetime
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from sheeprl_tpu_torch.config.core import DotDict, _parse_value, _set_dotted, load_config
from sheeprl_tpu_torch.parallel.context import make_run_context
from sheeprl_tpu_torch.utils.registry import get_evaluation


def _import_algorithms() -> None:
    """Populate the registries."""
    import sheeprl_tpu_torch.algos  # noqa: F401  (registers on import)


def _default_run_name(cfg: Dict[str, Any]) -> str:
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    return f"{stamp}_{cfg.get('exp_name', 'run')}_{cfg.get('seed', 0)}"


def eval_algorithm(cfg: DotDict) -> Any:
    """Evaluation dispatch: one process, one environment, on ``cfg.device``. ``cfg`` is
    the run's saved config with the user's overrides merged on top. Returns what the
    algorithm's evaluation entry returns."""
    ckpt_path = Path(cfg.checkpoint_path)
    if "capture_video" in cfg:  # top-level alias for env.capture_video
        cfg.env.capture_video = bool(cfg.capture_video)
    cfg.env.num_envs = 1
    cfg.run_name = cfg.get("run_name") or _default_run_name(cfg)
    evaluate_fn = get_evaluation(cfg.algo.name)
    ctx = make_run_context(cfg)
    return evaluate_fn(ctx, cfg, str(ckpt_path))


def _load_checkpoint_cfg(overrides: List[str], path_key: str) -> tuple:
    """Extract ``<path_key>=...`` from the overrides, load the checkpoint run's
    ``config.yaml`` (two levels up, beside the checkpoint, or inside it) and apply the
    remaining overrides on top."""
    ckpt = None
    rest = []
    for ov in overrides:
        if ov.startswith(f"{path_key}="):
            ckpt = ov.split("=", 1)[1]
        else:
            rest.append(ov)
    if ckpt is None:
        raise ValueError(f"this entry point requires {path_key}=<path>")
    ckpt_path = Path(ckpt)
    run_dir = ckpt_path.parent.parent if ckpt_path.is_dir() else ckpt_path.parent
    cfg_path = run_dir / "config.yaml"
    if not cfg_path.is_file():
        cfg_path = ckpt_path.parent / "config.yaml"
    if not cfg_path.is_file() and ckpt_path.is_dir():
        cfg_path = ckpt_path / "config.yaml"
    if not cfg_path.is_file():
        raise FileNotFoundError(f"No config.yaml found alongside checkpoint {ckpt}")
    cfg = load_config(cfg_path)
    for ov in rest:
        if "=" not in ov:
            raise ValueError(f"Malformed override {ov!r}")
        key, _, val = ov.partition("=")
        _set_dotted(cfg, key.lstrip("+"), _parse_value(val))
    return DotDict.wrap(cfg), ckpt_path


def evaluate(args: Optional[List[str]] = None) -> Any:
    """Eval entry: ``python -m sheeprl_tpu_torch.eval checkpoint_path=... [overrides]``.
    Returns the evaluation entry's result."""
    _import_algorithms()
    overrides = list(args if args is not None else sys.argv[1:])
    cfg, ckpt_path = _load_checkpoint_cfg(overrides, "checkpoint_path")
    cfg.checkpoint_path = str(ckpt_path)
    # Eval records a video by default regardless of the training run's setting; an
    # explicit override still wins.
    overridden = {ov.partition("=")[0].lstrip("+") for ov in overrides}
    if not overridden & {"env.capture_video", "capture_video"}:
        cfg.env.capture_video = True
    return eval_algorithm(cfg)
