"""P2E on DreamerV2: the agent (counterpart of ``sheeprl_tpu/algos/p2e_dv2/agent.py``).

DreamerV2's world model, task actor, critic and target critic, an exploration actor,
critic and target critic of the same build, and the disagreement ensemble, which
predicts the next **posterior** (``stochastic_size * discrete_size`` wide) from
``[posterior, recurrent state, action]``."""

from __future__ import annotations

import copy
from typing import Any, Dict, Sequence, Tuple

import torch

from sheeprl_tpu_torch.algos.dreamer_v2.agent import (
    PlayerState,
    build_agent as dv2_build_agent,
    make_player_step,
    parse_actions_dim,
    xavier_normal_init,
)
from sheeprl_tpu_torch.algos.p2e import build_ensembles, fresh_copy
from sheeprl_tpu_torch.envs import spaces

__all__ = ["PlayerState", "build_agent", "make_player_step", "parse_actions_dim"]


def build_agent(
    ctx,
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg: Dict[str, Any],
    obs_space: spaces.Dict,
) -> Tuple[Dict[str, torch.nn.Module], int]:
    """``({name: module}, latent_size)``, the modules under the names of the checkpoint:
    ``world_model``, ``actor_task``, ``critic_task``, ``target_critic_task``,
    ``actor_exploration``, ``critic_exploration``, ``target_critic_exploration`` and
    ``ensembles``; each target critic starts as its critic."""
    world_model, actor, critic, target_critic, latent_size = dv2_build_agent(ctx, actions_dim, is_continuous, cfg, obs_space)
    wm_cfg = cfg.algo.world_model
    stoch_size = wm_cfg.stochastic_size * wm_cfg.discrete_size
    critic_expl = fresh_copy(critic, ctx, xavier_normal_init)
    modules = {
        "world_model": world_model,
        "actor_task": actor,
        "critic_task": critic,
        "target_critic_task": target_critic,
        "actor_exploration": fresh_copy(actor, ctx, xavier_normal_init),
        "critic_exploration": critic_expl,
        "target_critic_exploration": copy.deepcopy(critic_expl),
        "ensembles": build_ensembles(
            ctx, cfg, int(sum(actions_dim)) + wm_cfg.recurrent_model.recurrent_state_size + stoch_size, stoch_size, cfg.algo.dense_act, cfg.algo.layer_norm
        ),
    }
    return modules, latent_size
