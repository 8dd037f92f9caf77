"""SAC agent (counterpart of ``sheeprl_tpu/algos/sac/agent.py``).

* ``SACActor``: an MLP of two ReLU layers and a ``[mean, log_std]`` head, the log-std
  squashed by tanh into ``[LOG_STD_MIN, LOG_STD_MAX]`` (``agent.py:41-43`` there).
* ``SACCriticEnsemble``: the reference's ``nn.vmap`` over ``n`` critic MLPs as one
  module of stacked ``[n, in, out]`` weights (``algos/p2e::Ensembles``): every layer is
  one batched product over the members; ``forward(obs, action) -> [n, B, 1]``.
* ``SACAgent``: the actor, the critic, the target critic and the 0-d ``log_alpha``, the
  reference's parameter tree as one module (its children named as that tree's keys, so
  ``algos/dreamer_v3/params.py`` carries it by rule). The target critic starts as a copy
  of the critic, not as the reference's alias of it (``agent.py:102``): the port updates
  it in place, which would otherwise move the critic too.

The layers compute in the train policy's dtype (``precision/policy.py``) over float32
parameters, initialised as Flax's defaults; the heads' outputs are float32.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import flax_default_init
from sheeprl_tpu_torch.algos.p2e import Ensembles
from sheeprl_tpu_torch.distributions import TanhNormal
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.models.blocks import MLP, Linear, set_compute_dtype
from sheeprl_tpu_torch.precision import train_policy

LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0


class SACActor(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int, hidden_size: int = 256):
        super().__init__()
        self.mlp = MLP(obs_dim, (hidden_size, hidden_size), activation="relu")
        self.dense = nn.ModuleList([Linear(hidden_size, 2 * act_dim)])

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self.dense[0](self.mlp(obs)).float()
        mean, log_std = out.chunk(2, -1)
        log_std = LOG_STD_MIN + 0.5 * (LOG_STD_MAX - LOG_STD_MIN) * (torch.tanh(log_std) + 1)
        return mean, log_std

    @staticmethod
    def dist(mean: torch.Tensor, log_std: torch.Tensor) -> TanhNormal:
        return TanhNormal(mean, torch.exp(log_std))


class SACCriticEnsemble(Ensembles):
    """``n`` critics over ``[obs, action]``: two ReLU layers of ``hidden_size`` and a
    scalar head each, stacked."""

    def __init__(self, input_dim: int, n: int = 2, hidden_size: int = 256):
        super().__init__(n, input_dim, 1, dense_units=hidden_size, mlp_layers=2, activation="relu")

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return super().forward(torch.cat([obs, action.to(obs.dtype)], -1)).float()


class SACAgent(nn.Module):
    """The SAC and DroQ parameter tree: ``actor``, ``critic``, ``critic_target``,
    ``log_alpha``."""

    def __init__(self, actor: nn.Module, critic: nn.Module, alpha: float):
        super().__init__()
        self.actor = actor
        self.critic = critic
        self.critic_target = copy.deepcopy(critic)
        self.log_alpha = nn.Parameter(torch.tensor(math.log(alpha), dtype=torch.float32))

    @torch.no_grad()
    def reset_target(self) -> None:
        for t, s in zip(self.critic_target.parameters(), self.critic.parameters()):
            t.copy_(s)


def action_dim(action_space: Any, algo: str = "SAC") -> int:
    if not isinstance(action_space, spaces.Box):
        raise ValueError(f"{algo} supports continuous (Box) action spaces only, as the reference does")
    return int(np.prod(action_space.shape))


def vector_dim(obs_space: Any, mlp_keys) -> int:
    return int(sum(np.prod(obs_space[k].shape) for k in mlp_keys))


def init_agent(agent: nn.Module, ctx, dtype: torch.dtype) -> nn.Module:
    """Flax's default initialisation from ``ctx.rng()`` (the stacked ensembles member by
    member), the target copies equal to their sources, the compute dtype set; on
    ``ctx.device``."""
    gen = ctx.rng(device="cpu")
    flax_default_init(agent, gen)
    for m in agent.modules():
        if isinstance(m, Ensembles):
            m.reset_parameters(gen)
    for m in agent.modules():
        if hasattr(m, "reset_target"):
            m.reset_target()
    return set_compute_dtype(agent, dtype).to(ctx.device)


def build_agent(ctx, action_space: Any, obs_space: Any, cfg: Any) -> SACAgent:
    """SAC's agent over ``algo.mlp_keys.encoder`` in the train policy's dtype."""
    act_dim = action_dim(action_space)
    obs_dim = vector_dim(obs_space, cfg.algo.mlp_keys.encoder)
    actor = SACActor(obs_dim, act_dim, cfg.algo.actor.hidden_size)
    critic = SACCriticEnsemble(obs_dim + act_dim, cfg.algo.critic.n, cfg.algo.critic.hidden_size)
    return init_agent(SACAgent(actor, critic, cfg.algo.alpha.alpha), ctx, train_policy(cfg, ctx))
