"""P2E on DreamerV1: the agent (counterpart of ``sheeprl_tpu/algos/p2e_dv1/agent.py``).

DreamerV1's world model, task actor and critic, an exploration actor and critic of the
same build (no target critics, as in DreamerV1), and the disagreement ensemble, which
predicts the next **observation embedding** from ``[posterior, recurrent state,
action]``."""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from sheeprl_tpu_torch.algos.dreamer_v1.agent import PlayerState, build_agent as dv1_build_agent, make_player_step, parse_actions_dim
from sheeprl_tpu_torch.algos.dreamer_v2.agent import xavier_normal_init
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
    ``world_model``, ``actor_task``, ``critic_task``, ``actor_exploration``,
    ``critic_exploration`` and ``ensembles``."""
    world_model, actor, critic, latent_size = dv1_build_agent(ctx, actions_dim, is_continuous, cfg, obs_space)
    wm_cfg = cfg.algo.world_model
    ens_in = int(sum(actions_dim)) + wm_cfg.recurrent_model.recurrent_state_size + wm_cfg.stochastic_size
    modules = {
        "world_model": world_model,
        "actor_task": actor,
        "critic_task": critic,
        "actor_exploration": fresh_copy(actor, ctx, xavier_normal_init),
        "critic_exploration": fresh_copy(critic, ctx, xavier_normal_init),
        "ensembles": build_ensembles(ctx, cfg, ens_in, world_model.encoder.output_dim, cfg.algo.dense_act, False),
    }
    return modules, latent_size
