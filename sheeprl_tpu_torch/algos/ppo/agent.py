"""PPO agent (counterpart of ``sheeprl_tpu/algos/ppo/agent.py``): the shared
``MultiEncoder``, an actor backbone with one head per discrete action component (or one
``[mean, log_std]`` head for a continuous action), and a critic. The same module acts
and trains, as the reference's one Flax module does.

The layers compute in the train policy's dtype (``precision/policy.py``: bf16 under
the default ``bf16-mixed``) over float32 parameters; the heads' outputs are cast to
float32 (``agent.py:83-89`` there). Children follow the reference's names
(``feature_extractor``, ``actor_backbone``, ``critic``; ``actor_head_<i>`` is
``actor_heads.<i>``), so ``algos/dreamer_v3/params.py`` carries its parameters by rule.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import flax_default_init
from sheeprl_tpu_torch.algos.dreamer_v3.agent import parse_actions_dim as parse_action_space  # (is_continuous, dims)
from sheeprl_tpu_torch.models.blocks import MLP, Linear, MultiEncoder, set_compute_dtype
from sheeprl_tpu_torch.precision import train_policy


def encoder_shapes(obs_space: Any, cnn_keys: Sequence[str], mlp_keys: Sequence[str]) -> Tuple[Dict[str, Tuple[int, ...]], Dict[str, int]]:
    """The ``MultiEncoder``'s image shapes and vector widths from the observation space."""
    return (
        {k: tuple(obs_space[k].shape) for k in cnn_keys},
        {k: int(np.prod(obs_space[k].shape)) for k in mlp_keys},
    )


def make_encoder(cfg: Any, obs_space: Any) -> MultiEncoder:
    """The PPO family's ``MultiEncoder`` from ``algo``'s keys and widths."""
    cnn_shapes, mlp_dims = encoder_shapes(obs_space, cfg.algo.cnn_keys.encoder, cfg.algo.mlp_keys.encoder)
    return MultiEncoder(
        cnn_shapes,
        mlp_dims,
        cnn_features_dim=cfg.algo.encoder.cnn_features_dim,
        mlp_hidden_sizes=(cfg.algo.dense_units,) * cfg.algo.mlp_layers,
        mlp_features_dim=cfg.algo.encoder.mlp_features_dim,
        activation=cfg.algo.dense_act,
        layer_norm=cfg.algo.layer_norm,
    )


def make_heads(in_dim: int, action_dims: Sequence[int], is_continuous: bool) -> nn.ModuleList:
    """One ``[mean, log_std]`` head for a continuous action, one logits head per discrete
    component."""
    if is_continuous:
        return nn.ModuleList([Linear(in_dim, 2 * action_dims[0])])
    return nn.ModuleList(Linear(in_dim, d) for d in action_dims)


class PPOAgent(nn.Module):
    def __init__(self, encoder: MultiEncoder, action_dims: Sequence[int], is_continuous: bool, dense_units: int = 64, mlp_layers: int = 2, dense_act: str = "tanh", layer_norm: bool = False):
        super().__init__()
        self.action_dims = tuple(action_dims)
        self.is_continuous = is_continuous
        self.feature_extractor = encoder
        feat = encoder.output_dim
        hidden = (dense_units,) * mlp_layers
        self.actor_backbone = MLP(feat, hidden, activation=dense_act, layer_norm=layer_norm)
        self.critic = MLP(feat, hidden, 1, activation=dense_act, layer_norm=layer_norm)
        heads = make_heads(self.actor_backbone.output_dim, action_dims, is_continuous)
        if is_continuous:
            self.actor_head = heads[0]
        else:
            self.actor_heads = heads

    def forward(self, obs: Dict[str, torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """``(actor_out, value)``: the heads' float32 outputs and the ``[..., 1]`` value."""
        feat = self.feature_extractor(obs)
        pre_actor = self.actor_backbone(feat)
        heads = [self.actor_head] if self.is_continuous else self.actor_heads
        return [h(pre_actor).float() for h in heads], self.critic(feat).float()


def build_agent(ctx, action_space: Any, obs_space: Any, cfg: Any) -> PPOAgent:
    """The agent on ``ctx.device``, computing in the train policy's dtype over float32
    parameters initialised as Flax's defaults from ``ctx.rng()``."""
    is_continuous, dims = parse_action_space(action_space)
    agent = PPOAgent(
        make_encoder(cfg, obs_space),
        dims,
        is_continuous,
        dense_units=cfg.algo.dense_units,
        mlp_layers=cfg.algo.mlp_layers,
        dense_act=cfg.algo.dense_act,
        layer_norm=cfg.algo.layer_norm,
    )
    flax_default_init(agent, ctx.rng(device="cpu"))
    return set_compute_dtype(agent, train_policy(cfg, ctx)).to(ctx.device)
