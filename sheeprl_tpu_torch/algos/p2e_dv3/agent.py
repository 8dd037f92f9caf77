"""P2E on DreamerV3: the agent (counterpart of ``sheeprl_tpu/algos/p2e_dv3/agent.py``).

DreamerV3's world model, task actor, critic and target critic; an exploration actor of
the task actor's build (Hafner-initialised); one critic and its EMA target per entry of
``algo.critics_exploration`` whose weight is positive (``critics_exploration``, a
``ModuleDict`` of ``{"module", "target"}`` in the config's order, as the reference's
tree); and the disagreement ensemble, SiLU with LayerNorm, which predicts the next
posterior from ``[posterior, recurrent state, action]``."""

from __future__ import annotations

import copy
from typing import Any, Dict, Sequence, Tuple

import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    PlayerState,
    apply_hafner_init,
    build_agent as dv3_build_agent,
    flax_default_init,
    make_player_step,
    parse_actions_dim,
    zero_init_head,
)
from sheeprl_tpu_torch.algos.p2e import build_ensembles, fresh_copy
from sheeprl_tpu_torch.envs import spaces

__all__ = ["PlayerState", "build_agent", "critic_configs", "make_player_step", "parse_actions_dim"]


def critic_configs(cfg) -> Dict[str, Dict[str, Any]]:
    """The exploration critics, ``{name: {"weight", "reward_type"}}``, for each entry of
    ``algo.critics_exploration`` whose weight is positive, in the config's order."""
    return {
        k: {"weight": v["weight"], "reward_type": v["reward_type"]}
        for k, v in cfg.algo.critics_exploration.items()
        if v["weight"] > 0
    }


def build_agent(
    ctx,
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg: Dict[str, Any],
    obs_space: spaces.Dict,
) -> Tuple[Dict[str, nn.Module], int]:
    """``({name: module}, latent_size)``, the modules under the names of the checkpoint:
    ``world_model``, ``actor_task``, ``critic_task``, ``target_critic_task``,
    ``actor_exploration``, ``critics_exploration`` and ``ensembles``. Raises
    ``RuntimeError`` where no exploration critic is ``intrinsic``."""
    world_model, actor, critic, target_critic, latent_size = dv3_build_agent(ctx, actions_dim, is_continuous, cfg, obs_space)
    hafner = cfg.algo.hafner_initialization

    def actor_init(m: nn.Module, gen: torch.Generator) -> None:
        flax_default_init(m, gen)
        if hafner:
            apply_hafner_init(m, gen)

    def critic_init(m: nn.Module, gen: torch.Generator) -> None:
        flax_default_init(m, gen)
        if hafner:
            zero_init_head(m.head)

    actor_expl = fresh_copy(actor, ctx, actor_init)
    critics = nn.ModuleDict()
    configs = critic_configs(cfg)
    for name in configs:
        module = fresh_copy(critic, ctx, critic_init)
        critics[name] = nn.ModuleDict({"module": module, "target": copy.deepcopy(module)})
    if not any(c["reward_type"] == "intrinsic" for c in configs.values()):
        raise RuntimeError("You must specify at least one intrinsic critic (`reward_type='intrinsic'`)")
    wm_cfg = cfg.algo.world_model
    stoch_size = wm_cfg.stochastic_size * wm_cfg.discrete_size
    ens_in = int(sum(actions_dim)) + wm_cfg.recurrent_model.recurrent_state_size + stoch_size
    modules = {
        "world_model": world_model,
        "actor_task": actor,
        "critic_task": critic,
        "target_critic_task": target_critic,
        "actor_exploration": actor_expl,
        "critics_exploration": critics,
        "ensembles": build_ensembles(ctx, cfg, ens_in, stoch_size, "silu", True),
    }
    return modules, latent_size
