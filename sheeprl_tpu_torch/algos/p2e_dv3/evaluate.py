"""P2E-DV3 evaluation entry (counterpart of ``sheeprl_tpu/algos/p2e_dv3/evaluate.py``): the
actor ``algo.player.actor_type`` names; a finetuning run's, always the task actor."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.dreamer_loop import evaluate_actor
from sheeprl_tpu_torch.algos.dreamer_v3.utils import TestResult
from sheeprl_tpu_torch.algos.p2e import evaluated_actor
from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent, make_player_step
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms=["p2e_dv3_exploration", "p2e_dv3_finetuning"])
def evaluate_p2e_dv3(ctx, cfg: Dict[str, Any], ckpt_path: str) -> TestResult:
    wm_cfg = cfg.algo.world_model
    build = lambda *args: build_agent(*args)[0]  # noqa: E731
    make_player = lambda wm, actor, actions_dim, _: make_player_step(wm, actor, actions_dim, wm_cfg.discrete_size)  # noqa: E731
    return evaluate_actor(ctx, cfg, ckpt_path, build, make_player, evaluated_actor(cfg), wm_cfg.stochastic_size * wm_cfg.discrete_size)
