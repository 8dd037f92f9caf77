"""SAC-AE evaluation entry (counterpart of ``sheeprl_tpu/algos/sac_ae/evaluate.py``):
the greedy actor on the encoder's features of the frames."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_v3.utils import TestResult
from sheeprl_tpu_torch.algos.sac.evaluate import evaluate_agent
from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms=["sac_ae"])
def evaluate_sac_ae(ctx, cfg: Dict[str, Any], ckpt_path: str) -> TestResult:
    return evaluate_agent(ctx, cfg, ckpt_path, build_agent, pixels=True)
