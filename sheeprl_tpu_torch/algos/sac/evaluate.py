"""SAC, DroQ and SAC-AE evaluation entries (counterparts of
``sheeprl_tpu/algos/{sac,droq,sac_ae}/evaluate.py``): one greedy test episode (``tanh``
of the actor's mean) of the checkpoint's agent. ``sac_decoupled`` checkpoints hold SAC's
agent, as in the reference."""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.utils import TestResult
from sheeprl_tpu_torch.algos.ppo.evaluate import print_result
from sheeprl_tpu_torch.algos.sac.utils import pixel_rows, test, vector_rows
from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
from sheeprl_tpu_torch.utils.env import make_env
from sheeprl_tpu_torch.utils.logger import get_log_dir
from sheeprl_tpu_torch.utils.policy import extract_policy_params
from sheeprl_tpu_torch.utils.registry import register_evaluation


def evaluate_agent(ctx, cfg: Dict[str, Any], ckpt_path: str, build: Callable, pixels: bool = False) -> TestResult:
    """``build(ctx, action_space, obs_space, cfg)`` makes the agent the checkpoint
    holds; ``pixels``: the actor reads the encoder's features of the frames (SAC-AE)."""
    log_dir = get_log_dir(cfg)
    env = make_env(cfg, cfg.seed, 0, log_dir, "test")()
    obs_space, act_space = env.observation_space, env.action_space
    env.close()
    agent = build(ctx, act_space, obs_space, cfg)
    state = CheckpointManager.load(ckpt_path, map_location=ctx.device)
    agent.load_state_dict(extract_policy_params(state, cfg, cfg.algo.name))
    if pixels:
        keys = list(cfg.algo.cnn_keys.encoder)
        to_rows = lambda o: pixel_rows(o, keys)  # noqa: E731
        greedy = lambda rows: torch.tanh(agent.actor(agent.encoder(rows.float() / 255.0))[0])  # noqa: E731
    else:
        keys = list(cfg.algo.mlp_keys.encoder)
        to_rows = lambda o: vector_rows(o, keys)  # noqa: E731
        greedy = lambda rows: torch.tanh(agent.actor(rows)[0])  # noqa: E731
    result = test(greedy, to_rows, ctx, cfg, log_dir)
    print_result(result)
    return result


@register_evaluation(algorithms=["sac", "sac_decoupled"])
def evaluate_sac(ctx, cfg: Dict[str, Any], ckpt_path: str) -> TestResult:
    from sheeprl_tpu_torch.algos.sac.agent import build_agent

    return evaluate_agent(ctx, cfg, ckpt_path, build_agent)
