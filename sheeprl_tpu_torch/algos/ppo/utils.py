"""PPO helpers (counterpart of ``sheeprl_tpu/algos/ppo/utils.py``): observations to
the device, the actions' distributions, sampling with injectable draws, log-probs and
entropies, and the greedy test episode.

Draws: a discrete actor samples each head by Gumbel-max (``argmax(logits + gumbel)``, as
``jax.random.categorical``), a continuous one as ``mean + std * normal``. ``draws``, when
given, holds the noise: one Gumbel tensor per head, in head order, or the one normal
tensor; otherwise it is drawn from ``generator`` in that order.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.utils import TestResult
from sheeprl_tpu_torch.distributions import Categorical, Normal, gumbel_noise

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/entropy_loss",
}


def prepare_obs(obs: Dict[str, np.ndarray], cnn_keys: Sequence[str], mlp_keys: Sequence[str], device: torch.device) -> Dict[str, torch.Tensor]:
    """Env observations -> tensors on ``device``: images stay uint8 (the encoder scales
    them), vectors become float32."""
    out = {k: torch.as_tensor(np.asarray(obs[k])).to(device) for k in cnn_keys}
    out.update({k: torch.as_tensor(np.asarray(obs[k], dtype=np.float32)).to(device) for k in mlp_keys})
    return out


def actions_as_dist(actor_out: Sequence[torch.Tensor], is_continuous: bool):
    if is_continuous:
        mean, log_std = actor_out[0].chunk(2, -1)
        return Normal(mean, torch.exp(log_std))
    return [Categorical(logits) for logits in actor_out]


def draw_shapes(actor_out: Sequence[torch.Tensor], is_continuous: bool) -> List[Tuple[int, ...]]:
    """The shapes of one sampling's draws: each head's logits, or the action's mean."""
    if is_continuous:
        out = actor_out[0]
        return [(*out.shape[:-1], out.shape[-1] // 2)]
    return [tuple(o.shape) for o in actor_out]


def make_draws(actor_out: Sequence[torch.Tensor], is_continuous: bool, generator: Optional[torch.Generator]) -> List[torch.Tensor]:
    """One sampling's draws from ``generator``, on the heads' device."""
    like = actor_out[0]
    if is_continuous:
        return [torch.randn(s, generator=generator, device=like.device) for s in draw_shapes(actor_out, True)]
    return [gumbel_noise(s, like, generator) for s in draw_shapes(actor_out, False)]


def sample_actions(
    actor_out: Sequence[torch.Tensor],
    is_continuous: bool,
    greedy: bool = False,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(env_actions, stored_actions, logprob)``: discrete actions stacked over the heads
    ``[..., n_heads]`` (int64), or the continuous action; the log-prob summed over heads
    (or action dims)."""
    if not greedy and draws is None:
        draws = make_draws(actor_out, is_continuous, generator)
    if is_continuous:
        dist = actions_as_dist(actor_out, True)
        act = dist.mode if greedy else dist.sample(noise=draws[0])
        return act, act, dist.log_prob(act).sum(-1)
    dists = actions_as_dist(actor_out, False)
    acts = [d.mode if greedy else d.sample(gumbel=g) for d, g in zip(dists, draws or [None] * len(dists))]
    logprob = sum(d.log_prob(a) for d, a in zip(dists, acts))
    stacked = torch.stack(acts, -1)
    return stacked, stacked, logprob


def log_prob_and_entropy(actor_out: Sequence[torch.Tensor], actions: torch.Tensor, is_continuous: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    if is_continuous:
        dist = actions_as_dist(actor_out, True)
        return dist.log_prob(actions).sum(-1), dist.entropy().sum(-1)
    dists = actions_as_dist(actor_out, False)
    logprob = sum(d.log_prob(actions[..., i]) for i, d in enumerate(dists))
    return logprob, sum(d.entropy() for d in dists)


def env_actions(act_np: np.ndarray, is_continuous: bool, action_dims: Sequence[int], act_space) -> np.ndarray:
    """The vector env's actions from sampled ones ``[n_envs, ...]``: a continuous action
    clipped to a finite box, a single discrete component squeezed."""
    if is_continuous:
        low, high = act_space.low, act_space.high
        return np.clip(act_np, low, high) if np.isfinite(low).all() else act_np
    return act_np[..., 0] if len(action_dims) == 1 else act_np


def test(agent, ctx, cfg, log_dir: str, greedy: bool = True) -> TestResult:
    """One greedy single-env evaluation episode."""
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, cfg.seed, 0, log_dir, "test")()
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    gen = ctx.rng()
    obs, _ = env.reset(seed=cfg.seed)
    done, cum_reward, steps = False, 0.0, 0
    start = time.perf_counter()
    try:
        while not done:
            with torch.no_grad():
                obs_t = prepare_obs({k: np.asarray(v)[None] for k, v in obs.items()}, cnn_keys, mlp_keys, ctx.device)
                actor_out, _ = agent(obs_t)
                act = sample_actions(actor_out, agent.is_continuous, greedy, gen)[0].cpu().numpy()[0]
            if not agent.is_continuous and len(agent.action_dims) == 1:
                act = act.item()
            obs, reward, terminated, truncated, _ = env.step(act)
            done = bool(terminated or truncated)
            cum_reward += float(reward)
            steps += 1
    finally:
        env.close()
    return TestResult(cum_reward, steps, time.perf_counter() - start)
