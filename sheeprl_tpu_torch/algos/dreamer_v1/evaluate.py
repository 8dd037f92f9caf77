"""DreamerV1 evaluation entry (counterpart of ``sheeprl_tpu/algos/dreamer_v1/evaluate.py``)."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_loop import evaluate_actor
from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent, make_player_step
from sheeprl_tpu_torch.algos.dreamer_v3.utils import TestResult
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms=["dreamer_v1"])
def evaluate_dreamer_v1(ctx, cfg: Dict[str, Any], ckpt_path: str) -> TestResult:
    def build(*args):
        world_model, actor, _, _ = build_agent(*args)
        return {"world_model": world_model, "actor": actor}

    return evaluate_actor(ctx, cfg, ckpt_path, build, make_player_step, "actor", cfg.algo.world_model.stochastic_size)
