"""Recurrent PPO evaluation entry (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/evaluate.py``): one greedy test episode of the
checkpoint's agent, its state carried."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.ppo.evaluate import print_result
from sheeprl_tpu_torch.algos.ppo.utils import TestResult
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import test
from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
from sheeprl_tpu_torch.utils.env import make_env
from sheeprl_tpu_torch.utils.logger import get_log_dir
from sheeprl_tpu_torch.utils.policy import extract_policy_params
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms=["ppo_recurrent"])
def evaluate_ppo_recurrent(ctx, cfg: Dict[str, Any], ckpt_path: str) -> TestResult:
    log_dir = get_log_dir(cfg)
    env = make_env(cfg, cfg.seed, 0, log_dir, "test")()
    obs_space, act_space = env.observation_space, env.action_space
    env.close()
    agent = build_agent(ctx, act_space, obs_space, cfg)
    state = CheckpointManager.load(ckpt_path, map_location=ctx.device)
    agent.load_state_dict(extract_policy_params(state, cfg, cfg.algo.name))
    result = test(agent, ctx, cfg, log_dir)
    print_result(result)
    return result
