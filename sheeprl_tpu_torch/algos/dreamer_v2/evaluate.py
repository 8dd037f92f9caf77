"""DreamerV2 evaluation entry (counterpart of ``sheeprl_tpu/algos/dreamer_v2/evaluate.py``)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.agent import PlayerState, build_agent, make_player_step, parse_actions_dim
from sheeprl_tpu_torch.algos.dreamer_v3.utils import TestResult, test
from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
from sheeprl_tpu_torch.utils.env import make_env
from sheeprl_tpu_torch.utils.logger import get_log_dir
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms=["dreamer_v2"])
def evaluate_dreamer_v2(ctx, cfg: Dict[str, Any], ckpt_path: str) -> TestResult:
    log_dir = get_log_dir(cfg)
    env = make_env(cfg, cfg.seed, 0, log_dir, "test")()
    obs_space, act_space = env.observation_space, env.action_space
    env.close()
    is_continuous, actions_dim = parse_actions_dim(act_space)

    world_model, actor, _, _, _ = build_agent(ctx, actions_dim, is_continuous, cfg, obs_space)
    params = CheckpointManager.load(ckpt_path, map_location=ctx.device)["params"]
    world_model.load_state_dict(params["world_model"])
    actor.load_state_dict(params["actor"])
    world_model.eval()
    actor.eval()

    stoch_size = cfg.algo.world_model.stochastic_size * cfg.algo.world_model.discrete_size
    rec_size = cfg.algo.world_model.recurrent_model.recurrent_state_size
    act_dim_sum = int(sum(actions_dim))

    def player_state_init(n: int) -> PlayerState:
        zeros = lambda d: torch.zeros((n, d), device=ctx.device)  # noqa: E731
        return PlayerState(zeros(rec_size), zeros(stoch_size), zeros(act_dim_sum))

    player_step = make_player_step(world_model, actor, actions_dim, is_continuous)
    result = test(player_step, player_state_init, ctx, cfg, log_dir)
    print(f"Test/cumulative_reward: {result.reward}")
    print(f"Test/episode_steps: {result.steps}")
    print(f"Test/player_steps_per_second: {result.steps / result.seconds}")
    return result
