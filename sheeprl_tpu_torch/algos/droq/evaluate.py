"""DroQ evaluation entry (counterpart of ``sheeprl_tpu/algos/droq/evaluate.py``): DroQ's
agent (its Dropout + LayerNorm critics, so that the checkpoint loads whole), evaluated
by its actor."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v3.utils import TestResult
from sheeprl_tpu_torch.algos.droq.droq import build_agent
from sheeprl_tpu_torch.algos.sac.evaluate import evaluate_agent
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms=["droq"])
def evaluate_droq(ctx, cfg: Dict[str, Any], ckpt_path: str) -> TestResult:
    return evaluate_agent(ctx, cfg, ckpt_path, build_agent)
