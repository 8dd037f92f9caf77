"""PPO and A2C evaluation entry (counterpart of ``sheeprl_tpu/algos/ppo/evaluate.py``):
one greedy test episode of the checkpoint's agent."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.ppo.agent import build_agent
from sheeprl_tpu_torch.algos.ppo.utils import TestResult, test
from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.utils.env import make_env
from sheeprl_tpu_torch.utils.logger import get_log_dir
from sheeprl_tpu_torch.utils.policy import extract_policy_params
from sheeprl_tpu_torch.utils.registry import register_evaluation


def print_result(result: TestResult) -> None:
    print(f"Test/cumulative_reward: {result.reward}")
    print(f"Test/episode_steps: {result.steps}")
    print(f"Test/player_steps_per_second: {result.steps / result.seconds}")


@register_evaluation(algorithms=["ppo", "ppo_decoupled", "a2c"])
def evaluate_ppo(ctx, cfg: Dict[str, Any], ckpt_path: str) -> TestResult:
    log_dir = get_log_dir(cfg)
    env = make_env(cfg, cfg.seed, 0, log_dir, "test")()
    obs_space, act_space = env.observation_space, env.action_space
    env.close()
    if not isinstance(obs_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be a Dict space, got: {obs_space}")
    agent = build_agent(ctx, act_space, obs_space, cfg)
    state = CheckpointManager.load(ckpt_path, map_location=ctx.device)
    agent.load_state_dict(extract_policy_params(state, cfg, cfg.algo.name))
    result = test(agent, ctx, cfg, log_dir)
    print_result(result)
    return result
