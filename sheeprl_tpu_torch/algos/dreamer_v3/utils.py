"""DreamerV3 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v3/utils.py``): the
aggregated metric names, the return-normalising moments, observation transfer, the
greedy test rollout and the env-action conversion."""

from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
    "State/prior_entropy",
}


def init_moments(device: torch.device | str = "cpu") -> Dict[str, torch.Tensor]:
    return {"low": torch.zeros((), device=device), "high": torch.zeros((), device=device)}


def update_moments(
    state: Dict[str, torch.Tensor],
    x: torch.Tensor,
    decay: float = 0.99,
    max_: float = 1.0,
    percentile_low: float = 0.05,
    percentile_high: float = 0.95,
    levels: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Percentile return normaliser (DreamerV3's ``Moments``): EMA of the ``x``
    quantiles (linear interpolation, as ``jnp.quantile``). Returns ``(offset,
    invscale, new_state)``; no gradient flows through it. ``levels``, the float32
    tensor ``[percentile_low, percentile_high]`` on ``x``'s device, is made once by the
    caller, so that a step makes no host-to-device copy; without it the levels are
    made here."""
    x = x.detach().float().reshape(-1)
    if levels is None:
        levels = torch.tensor([percentile_low, percentile_high], device=x.device, dtype=x.dtype)
    q = torch.quantile(x, levels)
    new_low = decay * state["low"] + (1 - decay) * q[0]
    new_high = decay * state["high"] + (1 - decay) * q[1]
    invscale = torch.clamp_min(new_high - new_low, 1.0 / max_)
    return new_low, invscale, {"low": new_low, "high": new_high}


class TestResult(NamedTuple):
    reward: float  # cumulative reward of the episode
    steps: int  # player steps taken
    seconds: float  # wall time of the episode's player and env steps


def prepare_obs(
    obs: Dict[str, np.ndarray], cnn_keys: Sequence[str], mlp_keys: Sequence[str], num_envs: int, device: torch.device
) -> Dict[str, torch.Tensor]:
    """numpy env obs -> ``[num_envs, ...]`` tensors on ``device``; images stay uint8
    channel-first (the encoder normalises), vectors are flattened float32. ``mask*``
    entries ride along as bools for a masked actor."""
    out: Dict[str, torch.Tensor] = {}
    for k in cnn_keys:
        v = np.asarray(obs[k])
        out[k] = torch.as_tensor(v.reshape(num_envs, -1, *v.shape[-2:])).to(device, non_blocking=True)
    for k in mlp_keys:
        out[k] = torch.as_tensor(np.asarray(obs[k], dtype=np.float32).reshape(num_envs, -1)).to(device, non_blocking=True)
    for k in obs:
        if k.startswith("mask"):
            out[k] = torch.as_tensor(np.asarray(obs[k], dtype=bool).reshape(num_envs, -1)).to(device)
    return out


@torch.inference_mode()
def test(player_step, player_state_init, ctx, cfg, log_dir: str, greedy: bool = True, test_name: str = "test") -> TestResult:
    """One single-env episode with the greedy actor (the posterior is still sampled,
    from ``ctx.rng()``)."""
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, cfg.seed, 0, log_dir, test_name)()
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    generator = ctx.rng()
    obs, _ = env.reset(seed=cfg.seed)
    state = player_state_init(1)
    is_first = torch.ones((1, 1), device=ctx.device)
    done, cum_reward, steps = False, 0.0, 0
    start = time.perf_counter()
    while not done:
        obs_t = prepare_obs({k: np.asarray(v)[None] for k, v in obs.items()}, cnn_keys, mlp_keys, 1, ctx.device)
        actions, _, state = player_step(state, obs_t, is_first, generator, greedy=greedy)
        is_first = torch.zeros((1, 1), device=ctx.device)
        obs, reward, terminated, truncated, _ = env.step(_to_env_action(actions, env.action_space))
        done = bool(terminated or truncated)
        cum_reward += float(reward)
        steps += 1
    seconds = time.perf_counter() - start
    env.close()
    return TestResult(cum_reward, steps, seconds)


def _to_env_action(actions: Sequence[torch.Tensor], action_space) -> Any:
    acts = [a[0].float().cpu().numpy() for a in actions]
    if isinstance(action_space, spaces.Box):
        return acts[0].reshape(action_space.shape)
    if isinstance(action_space, spaces.Discrete):
        return int(acts[0].argmax(-1))
    return np.stack([a.argmax(-1) for a in acts])
