"""The SAC family's helpers (counterpart of ``sheeprl_tpu/algos/sac/utils.py``): the
logged keys, observations to rows, the env's actions from the policy's, and the greedy
test episode that SAC, DroQ and SAC-AE share."""

from __future__ import annotations

import time
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.utils import TestResult

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/alpha_loss",
}


def vector_rows(obs: Dict[str, np.ndarray], mlp_keys: Sequence[str]) -> np.ndarray:
    """The vector keys of ``[n, ...]`` observations flattened and concatenated into
    float32 ``[n, obs_dim]`` rows (SAC and DroQ read vector observations only)."""
    arrs = [np.asarray(obs[k], dtype=np.float32) for k in mlp_keys]
    return np.concatenate([a.reshape(a.shape[0], -1) for a in arrs], -1)


def pixel_rows(obs: Dict[str, np.ndarray], cnn_keys: Sequence[str]) -> np.ndarray:
    """The image keys of ``[n, ...]`` observations as uint8 ``[n, C, H, W]`` rows, stacked
    frames and keys concatenated along the channels (SAC-AE)."""
    parts = [np.asarray(obs[k]) for k in cnn_keys]
    return np.concatenate([p.reshape(p.shape[0], -1, *p.shape[-2:]) for p in parts], 1).astype(np.uint8)


def prepare_obs(obs: Dict[str, np.ndarray], mlp_keys: Sequence[str], device: torch.device) -> torch.Tensor:
    """``vector_rows`` on ``device``."""
    return torch.from_numpy(vector_rows(obs, mlp_keys)).to(device)


def env_actions(tanh_actions: np.ndarray, action_space) -> np.ndarray:
    """Actions in ``[-1, 1]`` rescaled to a bounded Box's range (unbounded: as they are)."""
    low, high = action_space.low, action_space.high
    if np.isfinite(low).all() and np.isfinite(high).all():
        return low + (tanh_actions + 1) * 0.5 * (high - low)
    return tanh_actions


def test(greedy: Callable[[torch.Tensor], torch.Tensor], to_rows: Callable, ctx, cfg, log_dir: str) -> TestResult:
    """One single-env episode of the greedy policy: ``greedy(rows)`` is ``tanh`` of the
    actor's mean for ``to_rows(obs)`` on the device."""
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, cfg.seed, 0, log_dir, "test")()
    obs, _ = env.reset(seed=cfg.seed)
    done, cum_reward, steps = False, 0.0, 0
    start = time.perf_counter()
    try:
        while not done:
            with torch.no_grad():
                rows = torch.from_numpy(to_rows({k: np.asarray(v)[None] for k, v in obs.items()})).to(ctx.device)
                act = greedy(rows).float().cpu().numpy()[0]
            obs, reward, terminated, truncated, _ = env.step(env_actions(act, env.action_space))
            done = bool(terminated or truncated)
            cum_reward += float(reward)
            steps += 1
    finally:
        env.close()
    return TestResult(cum_reward, steps, time.perf_counter() - start)
