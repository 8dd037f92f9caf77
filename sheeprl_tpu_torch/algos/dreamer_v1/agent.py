"""DreamerV1 agent modules (counterpart of ``sheeprl_tpu/algos/dreamer_v1/agent.py``).

DreamerV1 reuses DreamerV2's encoder, decoders, actor, critic and exploration noise
(``algos/dreamer_v2/agent.py``). What is its own:

* a Gaussian stochastic state (``stochastic_size`` wide, no classes): the
  representation and transition MLPs emit ``2 * stoch`` values, split into a mean and
  ``std = softplus(.) + min_std``, and a sample is ``mean + std * noise``;
* a plain GRU: the recurrent model is a dense layer and its activation into Flax's
  ``GRUCell`` (``FlaxGRUCell``), plain tensor code with no kernel of its own;
* no ``is_first`` mask in ``dynamic``: the player zeroes its state where an episode
  starts;
* 400 x 4 ELU reward and (where ``use_continues``) continue heads.

Initialisation is DreamerV2's (Xavier-normal kernels, zero biases). Randomness: every
sampling method takes an optional ``torch.Generator`` and injected normal noise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v2.agent import (
    ActorV2,
    CNNDecoderV2,
    CriticV2,
    EncoderV2,
    MinedojoActorV2,
    MLPDecoderV2,
    PlayerState,
    add_exploration_noise,
    cnn_output_side,
    parse_actions_dim,
    xavier_normal_init,
)
from sheeprl_tpu_torch.algos.dreamer_v3.agent import is_minedojo
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.models.blocks import MLP, Linear, set_compute_dtype
from sheeprl_tpu_torch.utils.utils import exploration_amount

__all__ = [
    "FlaxGRUCell",
    "PlayerState",
    "RSSMV1",
    "RecurrentModelV1",
    "WorldModelV1",
    "build_agent",
    "compute_stochastic_state",
    "exploration_amount",
    "make_player_step",
    "parse_actions_dim",
]


def compute_stochastic_state(
    state_information: torch.Tensor,
    min_std: float = 0.1,
    sample: bool = True,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``((mean, std), state)``: the last axis split into a mean and ``softplus(.) +
    min_std``; the state is ``mean + std * noise`` (``noise`` injected, else drawn from
    ``generator``), or the mean where ``sample`` is off."""
    mean, std = state_information.chunk(2, -1)
    std = F.softplus(std) + min_std
    if not sample:
        return (mean, std), mean
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return (mean, std), mean + std * noise


class FlaxGRUCell(nn.Module):
    """``flax.linen.GRUCell``'s formula: ``r = sigmoid(ir(x) + hr(h))``, ``z =
    sigmoid(iz(x) + hz(h))``, ``n = tanh(in(x) + r * hn(h))``, ``h' = (1 - z) * n + z *
    h``. The input layers ``ir``, ``iz`` and ``in_`` (Flax's ``in``, a Python keyword)
    carry a bias, of the state layers only ``hn`` does: ``torch.nn.GRUCell`` puts one on
    both sides of r and z. Every operation runs in the layers' compute dtype, on ``h``
    cast to it by the caller, as Flax's cell does."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.ir, self.iz, self.in_ = (Linear(input_size, hidden_size) for _ in range(3))
        self.hr, self.hz = (Linear(hidden_size, hidden_size, bias=False) for _ in range(2))
        self.hn = Linear(hidden_size, hidden_size)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(self.in_(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class RecurrentModelV1(nn.Module):
    """``input_proj`` (a dense layer of ``recurrent_state_size`` units and the activation)
    -> ``FlaxGRUCell``; the new state comes back in float32."""

    def __init__(self, input_size: int, recurrent_state_size: int, activation: str = "elu"):
        super().__init__()
        self.input_proj = MLP(input_size, (recurrent_state_size,), activation=activation)
        self.rnn = FlaxGRUCell(recurrent_state_size, recurrent_state_size)

    def forward(self, x: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        feat = self.input_proj(x)
        return self.rnn(recurrent_state.to(feat.dtype), feat).float()


class RSSMV1(nn.Module):
    """The Gaussian RSSM. ``dynamic`` and ``imagination`` take injected normal noise in
    place of the generator's."""

    def __init__(
        self,
        embed_size: int,
        action_size: int,
        stochastic_size: int = 30,
        recurrent_state_size: int = 200,
        transition_hidden_size: int = 200,
        representation_hidden_size: int = 200,
        min_std: float = 0.1,
        activation: str = "elu",
    ):
        super().__init__()
        self.stochastic_size = stochastic_size
        self.recurrent_state_size = recurrent_state_size
        self.min_std = min_std
        self.recurrent_model = RecurrentModelV1(stochastic_size + action_size, recurrent_state_size, activation)
        self.representation_model = MLP(
            recurrent_state_size + embed_size, (representation_hidden_size,), 2 * stochastic_size, activation=activation
        )
        self.transition_model = MLP(recurrent_state_size, (transition_hidden_size,), 2 * stochastic_size, activation=activation)

    def _representation(self, recurrent_state, embedded_obs, sample: bool = True, generator=None, noise=None):
        out = self.representation_model(torch.cat([recurrent_state, embedded_obs], -1)).float()
        return compute_stochastic_state(out, self.min_std, sample, generator, noise)

    def _transition(self, recurrent_state, sample: bool = True, generator=None, noise=None):
        out = self.transition_model(recurrent_state).float()
        return compute_stochastic_state(out, self.min_std, sample, generator, noise)

    def dynamic(
        self,
        posterior: torch.Tensor,
        recurrent_state: torch.Tensor,
        action: torch.Tensor,
        embedded_obs: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        """One posterior step, with no reset where an episode starts: GRU -> prior ->
        posterior. ``noise`` = (the prior's, the posterior's), ``[B, stoch]`` each.
        Returns ``(recurrent_state, posterior, prior, (posterior mean, std), (prior mean,
        std))``."""
        prior_noise, post_noise = noise if noise is not None else (None, None)
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], -1), recurrent_state)
        prior_ms, prior = self._transition(recurrent_state, generator=generator, noise=prior_noise)
        post_ms, post = self._representation(recurrent_state, embedded_obs, generator=generator, noise=post_noise)
        return recurrent_state, post, prior, post_ms, prior_ms

    def imagination(
        self,
        stochastic_state: torch.Tensor,
        recurrent_state: torch.Tensor,
        actions: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ):
        """One prior-only step: ``(imagined prior [B, stoch], recurrent_state)``."""
        recurrent_state = self.recurrent_model(torch.cat([stochastic_state, actions], -1), recurrent_state)
        _, imagined = self._transition(recurrent_state, generator=generator, noise=noise)
        return imagined, recurrent_state


class WorldModelV1(nn.Module):
    """DreamerV2's encoder and decoders around the Gaussian RSSM, a reward head and, where
    ``use_continues``, a continue head (dense stacks of ``mlp_layers`` x ``dense_units``
    and one output)."""

    def __init__(
        self,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_shapes: Dict[str, Tuple[int, ...]],
        mlp_shapes: Dict[str, Tuple[int, ...]],
        action_size: int,
        cnn_channels_multiplier: int = 32,
        dense_units: int = 400,
        mlp_layers: int = 4,
        stochastic_size: int = 30,
        recurrent_state_size: int = 200,
        transition_hidden_size: int = 200,
        representation_hidden_size: int = 200,
        min_std: float = 0.1,
        dense_act: str = "elu",
        cnn_act: str = "relu",
        use_continues: bool = False,
        image_size: int = 64,
    ):
        super().__init__()
        self.cnn_keys = list(cnn_keys)
        self.mlp_keys = list(mlp_keys)
        self.use_continues = use_continues
        self.encoder = EncoderV2(
            cnn_keys, mlp_keys, cnn_shapes, mlp_shapes, cnn_channels_multiplier, dense_units, mlp_layers, dense_act, False, image_size
        )
        self.rssm = RSSMV1(
            self.encoder.output_dim,
            action_size,
            stochastic_size,
            recurrent_state_size,
            transition_hidden_size,
            representation_hidden_size,
            min_std,
            dense_act,
        )
        latent = stochastic_size + recurrent_state_size
        if self.cnn_keys:
            self.observation_model_cnn = CNNDecoderV2(
                latent,
                {k: cnn_shapes[k] for k in self.cnn_keys},
                cnn_output_side(image_size) ** 2 * cnn_channels_multiplier * 8,
                cnn_channels_multiplier,
                cnn_act,
                False,
            )
        if self.mlp_keys:
            self.observation_model_mlp = MLPDecoderV2(latent, {k: mlp_shapes[k] for k in self.mlp_keys}, dense_units, mlp_layers, dense_act, False)
        self.reward_model = MLP(latent, (dense_units,) * mlp_layers, 1, activation=dense_act)
        if use_continues:
            self.continue_model = MLP(latent, (dense_units,) * mlp_layers, 1, activation=dense_act)

    def encode(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.encoder(obs)

    def decode(self, latent: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if self.cnn_keys:
            out.update(self.observation_model_cnn(latent))
        if self.mlp_keys:
            out.update(self.observation_model_mlp(latent))
        return out

    def reward(self, latent: torch.Tensor) -> torch.Tensor:
        return self.reward_model(latent).float()

    def continues(self, latent: torch.Tensor) -> torch.Tensor:
        return self.continue_model(latent).float()

    def dynamic(self, *args, **kwargs):
        return self.rssm.dynamic(*args, **kwargs)

    def imagination(self, *args, **kwargs):
        return self.rssm.imagination(*args, **kwargs)

    def representation(self, recurrent_state, embedded_obs, sample: bool = True, generator=None, noise=None):
        return self.rssm._representation(recurrent_state, embedded_obs, sample, generator, noise)


def build_agent(
    ctx,
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg: Dict[str, Any],
    obs_space: spaces.Dict,
):
    """Build the world model, actor and critic on ``ctx.device``, initialised as the
    reference initialises them, from ``ctx.rng()``, computing in ``ctx.compute_dtype``
    over float32 parameters.

    Returns ``(world_model, actor, critic, latent_size)``."""
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    wm_cfg = cfg.algo.world_model
    act = cfg.algo.dense_act
    world_model = WorldModelV1(
        cnn_keys=cnn_keys,
        mlp_keys=mlp_keys,
        cnn_shapes={k: tuple(obs_space[k].shape) for k in cnn_keys},
        mlp_shapes={k: tuple(obs_space[k].shape) for k in mlp_keys},
        action_size=int(sum(actions_dim)),
        cnn_channels_multiplier=wm_cfg.encoder.cnn_channels_multiplier,
        dense_units=cfg.algo.dense_units,
        mlp_layers=cfg.algo.mlp_layers,
        stochastic_size=wm_cfg.stochastic_size,
        recurrent_state_size=wm_cfg.recurrent_model.recurrent_state_size,
        transition_hidden_size=wm_cfg.transition_model.hidden_size,
        representation_hidden_size=wm_cfg.representation_model.hidden_size,
        min_std=wm_cfg.min_std,
        dense_act=act,
        cnn_act=cfg.algo.cnn_act,
        use_continues=wm_cfg.use_continues,
        image_size=cfg.env.screen_size,
    )
    latent_size = wm_cfg.stochastic_size + wm_cfg.recurrent_model.recurrent_state_size
    actor = (MinedojoActorV2 if is_minedojo(cfg) else ActorV2)(
        latent_size,
        actions_dim,
        is_continuous,
        distribution=cfg.distribution.get("type", "auto"),
        dense_units=cfg.algo.actor.dense_units,
        mlp_layers=cfg.algo.actor.mlp_layers,
        activation=act,
        layer_norm=False,
        init_std=cfg.algo.actor.init_std,
        min_std=cfg.algo.actor.min_std,
    )
    critic = CriticV2(latent_size, cfg.algo.critic.dense_units, cfg.algo.critic.mlp_layers, act, False)
    gen = ctx.rng(device="cpu")
    for m in (world_model, actor, critic):
        xavier_normal_init(m, gen)
    modules = [set_compute_dtype(m, ctx.compute_dtype).to(ctx.device) for m in (world_model, actor, critic)]
    return (*modules, latent_size)


def make_player_step(world_model: WorldModelV1, actor: ActorV2, actions_dim: Sequence[int], is_continuous: bool):
    """The player step: ``(state, obs, is_first, generator, greedy, draws, expl_amount)``
    -> ``(env_actions, stored_actions, new_state)``.

    ``is_first`` rows restart from zeros. The posterior is sampled even when ``greedy``
    (only the actor is greedy), and exploration noise is added unless ``greedy``.
    ``draws`` (optional) is ``(the posterior's normal noise [B, stoch], action draws per
    head, exploration draws)``; any part may be None."""

    def player_step(
        state: PlayerState,
        obs: Dict[str, torch.Tensor],
        is_first: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        greedy: bool = False,
        draws: Optional[Tuple[Any, Any, Any]] = None,
        expl_amount: float = 0.0,
    ):
        stoch_noise, action_draws, expl_draws = draws if draws is not None else (None, None, None)
        mask = {k: v for k, v in obs.items() if k.startswith("mask")} or None
        embed = world_model.encode(obs)
        keep = 1 - is_first
        recurrent = world_model.rssm.recurrent_model(
            torch.cat([keep * state.stochastic_state, keep * state.actions], -1), keep * state.recurrent_state
        )
        _, stoch = world_model.representation(recurrent, embed, generator=generator, noise=stoch_noise)
        actions, _ = actor(torch.cat([stoch, recurrent], -1), generator, greedy, mask, action_draws)
        if not greedy:
            actions = add_exploration_noise(actions, expl_amount, is_continuous, generator, expl_draws)
        stored = torch.cat(actions, -1)
        return actions, stored, PlayerState(recurrent, stoch, stored)

    return player_step
