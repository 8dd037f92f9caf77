"""DreamerV2 agent modules (counterpart of ``sheeprl_tpu/algos/dreamer_v2/agent.py``).

What sets them apart from the DreamerV3 modules (``algos/dreamer_v3/agent.py``), whose
layout rules (channel-first images, channel LayerNorms, ``H, W, C`` flattening) and
pieces (the conv trunk, the actor and critic heads) they reuse:

* ELU activations and LayerNorm only where ``algo.layer_norm`` asks (eps 1e-5); the GRU
  cell's own LayerNorm is always on (eps 1e-3), and so is the recurrent model's input
  LayerNorm unless ``recurrent_model.layer_norm`` is off;
* a VALID conv encoder (k=4, s=2: 64x64 -> 2x2) and Hafner's decoder (1x1 -> k=5, 5, 6,
  6 transposed convs -> 64x64);
* no unimix on the categoricals, and a zero (not learned) initial state: ``is_first``
  multiplies the carried state by ``1 - is_first``;
* Gaussian heads: the reward and the critic emit one mean, and the continuous actor
  defaults to ``trunc_normal``;
* exploration noise added to the player's actions.

Initialisation is the reference's: Xavier-normal kernels (both fans count the conv's
receptive field, as ``torch.nn.init.xavier_normal_``), zero biases, unit LayerNorms.
Randomness: every sampling method takes an optional ``torch.Generator`` and injected
draws, as the DreamerV3 modules do. On MineDojo the actor is ``MinedojoActorV2``, the
DreamerV3 ``MinedojoActor``'s masked heads on this family's trunk (no unimix).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    CNNEncoder,
    DreamerActor,
    DreamerCritic,
    MinedojoMasks,
    PlayerState,
    _channel_norm,
    compute_stochastic_state,
    is_minedojo,
    parse_actions_dim,
)
from sheeprl_tpu_torch.distributions import gumbel_noise
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.models.blocks import (
    MLP,
    ConvTranspose2d,
    LayerNorm,
    LayerNormGRUCell,
    Linear,
    _activation,
    set_compute_dtype,
)
from sheeprl_tpu_torch.utils.utils import exploration_amount

__all__ = [
    "ActorV2",
    "MinedojoActorV2",
    "CNNDecoderV2",
    "CNNEncoderV2",
    "CriticV2",
    "EncoderV2",
    "MLPDecoderV2",
    "MLPEncoderV2",
    "PlayerState",
    "RSSMV2",
    "RecurrentModelV2",
    "WorldModelV2",
    "add_exploration_noise",
    "build_agent",
    "compute_stochastic_state",
    "exploration_amount",
    "make_player_step",
    "parse_actions_dim",
]

NORM_EPS = 1e-5  # the conv and MLP LayerNorms (Flax's default)


def cnn_output_side(image_size: int, stages: int = 4) -> int:
    """The side of the VALID encoder's last map (k=4, s=2): 64 -> 2."""
    side = image_size
    for _ in range(stages):
        side = (side - 4) // 2 + 1
    return side


class CNNEncoderV2(CNNEncoder):
    """4x (conv k=4 s=2 VALID -> [channel LayerNorm] -> activation): 64x64 -> 2x2x8m,
    flattened in ``H, W, C`` order."""

    def __init__(self, in_channels: int, channels_multiplier: int = 48, activation: str = "elu", layer_norm: bool = False):
        super().__init__(in_channels, channels_multiplier, 4, layer_norm, NORM_EPS, activation, padding=0)


class MLPEncoderV2(nn.Module):
    """A plain dense stack (no symlog)."""

    def __init__(self, input_dim: int, dense_units: int = 400, mlp_layers: int = 4, activation: str = "elu", layer_norm: bool = False):
        super().__init__()
        self.mlp = MLP(input_dim, (dense_units,) * mlp_layers, activation=activation, layer_norm=layer_norm, norm_eps=NORM_EPS)
        self.output_dim = self.mlp.output_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class EncoderV2(nn.Module):
    """The VALID conv trunk over the stacked images and a plain dense stack over the
    concatenated vectors (no symlog); the features are concatenated, float32."""

    def __init__(
        self,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_shapes: Dict[str, Tuple[int, ...]],
        mlp_shapes: Dict[str, Tuple[int, ...]],
        cnn_channels_multiplier: int = 48,
        dense_units: int = 400,
        mlp_layers: int = 4,
        activation: str = "elu",
        layer_norm: bool = False,
        image_size: int = 64,
    ):
        super().__init__()
        self.cnn_keys = list(cnn_keys)
        self.mlp_keys = list(mlp_keys)
        self.output_dim = 0
        if self.cnn_keys:
            in_ch = sum(int(cnn_shapes[k][0]) for k in self.cnn_keys)
            self.cnn_encoder = CNNEncoderV2(in_ch, cnn_channels_multiplier, activation, layer_norm)
            self.output_dim += cnn_output_side(image_size) ** 2 * cnn_channels_multiplier * 8
        if self.mlp_keys:
            in_dim = sum(int(np.prod(mlp_shapes[k])) for k in self.mlp_keys)
            self.mlp_encoder = MLPEncoderV2(in_dim, dense_units, mlp_layers, activation, layer_norm)
            self.output_dim += self.mlp_encoder.output_dim

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.cnn_keys:
            imgs = []
            for k in self.cnn_keys:
                img = obs[k]
                imgs.append(img.float() / 255.0 - 0.5 if img.dtype == torch.uint8 else img.float())
            feats.append(self.cnn_encoder(torch.cat(imgs, -3)))
        if self.mlp_keys:
            feats.append(self.mlp_encoder(torch.cat([obs[k].float() for k in self.mlp_keys], -1)))
        return torch.cat(feats, -1).float()


class CNNDecoderV2(nn.Module):
    """Latent -> ``latent_proj`` to the encoder's output size, read as a 1x1 map -> three
    VALID transposed convs (k=5, 5, 6; s=2; channels 4m, 2m, m) with optional channel
    LayerNorm and the activation -> the ``head`` transposed conv (k=6) to 64x64. Output
    channel-first, split per key."""

    KERNELS = (5, 5, 6, 6)

    def __init__(
        self,
        latent_size: int,
        output_shapes: Dict[str, Tuple[int, ...]],
        cnn_encoder_output_dim: int,
        channels_multiplier: int = 48,
        activation: str = "elu",
        layer_norm: bool = False,
    ):
        super().__init__()
        self.output_shapes = dict(output_shapes)
        total_c = sum(int(s[0]) for s in self.output_shapes.values())
        self.c0 = cnn_encoder_output_dim
        self.latent_proj = Linear(latent_size, cnn_encoder_output_dim)
        chans = [cnn_encoder_output_dim, channels_multiplier * 4, channels_multiplier * 2, channels_multiplier]
        # Flax's ConvTranspose(padding="VALID") pads the stride-dilated input by k - 1 on
        # each side, as ConvTranspose2d(padding=0) does; params.py flips the kernel
        self.deconvs = nn.ModuleList(
            ConvTranspose2d(a, b, k, stride=2, bias=not layer_norm) for a, b, k in zip(chans[:-1], chans[1:], self.KERNELS)
        )
        self.norms = nn.ModuleList(LayerNorm(c, NORM_EPS) for c in chans[1:]) if layer_norm else None
        self.head = ConvTranspose2d(chans[-1], total_c, self.KERNELS[-1], stride=2)
        self.act = _activation(activation)

    def forward(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.latent_proj(z)
        lead = x.shape[:-1]
        x = x.reshape(-1, self.c0, 1, 1)
        for i, deconv in enumerate(self.deconvs):
            x = deconv(x)
            if self.norms is not None:
                x = _channel_norm(self.norms[i], x)
            x = self.act(x)
        x = self.head(x).float()
        x = x.reshape(*lead, *x.shape[-3:])
        out, offset = {}, 0
        for k, shape in self.output_shapes.items():
            out[k] = x[..., offset : offset + shape[0], :, :]
            offset += shape[0]
        return out


class MLPDecoderV2(nn.Module):
    """Latent -> dense stack -> one linear head per vector key."""

    def __init__(
        self,
        latent_size: int,
        output_shapes: Dict[str, Tuple[int, ...]],
        dense_units: int = 400,
        mlp_layers: int = 4,
        activation: str = "elu",
        layer_norm: bool = False,
    ):
        super().__init__()
        self.mlp = MLP(latent_size, (dense_units,) * mlp_layers, activation=activation, layer_norm=layer_norm, norm_eps=NORM_EPS)
        self.heads = nn.ModuleDict({k: Linear(self.mlp.output_dim, int(np.prod(s))) for k, s in output_shapes.items()})

    def forward(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.mlp(z)
        return {k: head(x).float() for k, head in self.heads.items()}


class RecurrentModelV2(nn.Module):
    """``input_proj`` (dense, LayerNorm where ``layer_norm``, activation) ->
    ``LayerNormGRUCell`` of ``recurrent_state_size`` units, its LayerNorm always on: the
    ``layernorm_gru`` kernels on a card."""

    def __init__(self, input_size: int, recurrent_state_size: int, dense_units: int = 400, activation: str = "elu", layer_norm: bool = True):
        super().__init__()
        self.input_proj = MLP(input_size, (dense_units,), activation=activation, layer_norm=layer_norm, norm_eps=NORM_EPS)
        self.rnn = LayerNormGRUCell(dense_units, recurrent_state_size)

    def forward(self, x: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.rnn(recurrent_state, self.input_proj(x)).float()


class RSSMV2(nn.Module):
    """Discrete RSSM without unimix and with a zero initial state. ``dynamic`` and
    ``imagination`` take injected one-hot draws or Gumbel noise in place of the
    generator's."""

    def __init__(
        self,
        embed_size: int,
        action_size: int,
        stochastic_size: int = 32,
        discrete_size: int = 32,
        recurrent_state_size: int = 600,
        dense_units: int = 400,
        transition_hidden_size: int = 600,
        representation_hidden_size: int = 600,
        activation: str = "elu",
        layer_norm: bool = False,
        recurrent_layer_norm: bool = True,
    ):
        super().__init__()
        self.stochastic_size = stochastic_size
        self.discrete_size = discrete_size
        self.recurrent_state_size = recurrent_state_size
        stoch_out = stochastic_size * discrete_size
        self.recurrent_model = RecurrentModelV2(stoch_out + action_size, recurrent_state_size, dense_units, activation, recurrent_layer_norm)
        mlp = lambda n_in, hidden: MLP(n_in, (hidden,), activation=activation, layer_norm=layer_norm, norm_eps=NORM_EPS)  # noqa: E731
        self.representation_model = mlp(recurrent_state_size + embed_size, representation_hidden_size)
        self.repr_logits = Linear(representation_hidden_size, stoch_out)
        self.transition_model = mlp(recurrent_state_size, transition_hidden_size)
        self.trans_logits = Linear(transition_hidden_size, stoch_out)

    def _representation(self, recurrent_state, embedded_obs, sample: bool = True, generator=None, draw=None, gumbel=None):
        logits = self.repr_logits(self.representation_model(torch.cat([recurrent_state, embedded_obs], -1))).float()
        return logits, compute_stochastic_state(logits, self.discrete_size, sample, generator, draw, gumbel)

    def _transition(self, recurrent_state, sample: bool = True, generator=None, draw=None, gumbel=None):
        logits = self.trans_logits(self.transition_model(recurrent_state)).float()
        return logits, compute_stochastic_state(logits, self.discrete_size, sample, generator, draw, gumbel)

    def dynamic(
        self,
        posterior: torch.Tensor,
        recurrent_state: torch.Tensor,
        action: torch.Tensor,
        embedded_obs: torch.Tensor,
        is_first: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        gumbels: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        """One posterior step: ``is_first`` rows restart from zeros, then GRU -> prior ->
        posterior. ``draws`` = (prior one-hot, posterior one-hot); ``gumbels`` = (prior
        Gumbel noise, posterior Gumbel noise), ``[B, stoch, discrete]`` each. Returns
        ``(recurrent_state, posterior [B, stoch * discrete], prior [B, stoch, discrete],
        posterior_logits, prior_logits)``."""
        prior_draw, post_draw = draws if draws is not None else (None, None)
        prior_gumbel, post_gumbel = gumbels if gumbels is not None else (None, None)
        keep = 1 - is_first
        recurrent_state = self.recurrent_model(torch.cat([keep * posterior, keep * action], -1), keep * recurrent_state)
        prior_logits, prior = self._transition(recurrent_state, generator=generator, draw=prior_draw, gumbel=prior_gumbel)
        posterior_logits, posterior_sample = self._representation(
            recurrent_state, embedded_obs, generator=generator, draw=post_draw, gumbel=post_gumbel
        )
        return recurrent_state, posterior_sample.flatten(-2), prior, posterior_logits, prior_logits

    def imagination(
        self,
        prior: torch.Tensor,
        recurrent_state: torch.Tensor,
        actions: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        draw: Optional[torch.Tensor] = None,
        gumbel: Optional[torch.Tensor] = None,
    ):
        """One prior-only step: ``(imagined prior [B, stoch * discrete], recurrent_state)``."""
        recurrent_state = self.recurrent_model(torch.cat([prior, actions], -1), recurrent_state)
        _, imagined = self._transition(recurrent_state, generator=generator, draw=draw, gumbel=gumbel)
        return imagined.flatten(-2), recurrent_state


class WorldModelV2(nn.Module):
    """Encoder + RSSM + decoders + Gaussian reward head + the continue head where
    ``use_continues``."""

    def __init__(
        self,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_shapes: Dict[str, Tuple[int, ...]],
        mlp_shapes: Dict[str, Tuple[int, ...]],
        action_size: int,
        cnn_channels_multiplier: int = 48,
        dense_units: int = 400,
        mlp_layers: int = 4,
        stochastic_size: int = 32,
        discrete_size: int = 32,
        recurrent_state_size: int = 600,
        transition_hidden_size: int = 600,
        representation_hidden_size: int = 600,
        activation: str = "elu",
        layer_norm: bool = False,
        recurrent_layer_norm: bool = True,
        use_continues: bool = False,
        image_size: int = 64,
    ):
        super().__init__()
        self.cnn_keys = list(cnn_keys)
        self.mlp_keys = list(mlp_keys)
        self.use_continues = use_continues
        self.encoder = EncoderV2(
            cnn_keys, mlp_keys, cnn_shapes, mlp_shapes, cnn_channels_multiplier, dense_units, mlp_layers, activation, layer_norm, image_size
        )
        self.rssm = RSSMV2(
            self.encoder.output_dim,
            action_size,
            stochastic_size,
            discrete_size,
            recurrent_state_size,
            dense_units,
            transition_hidden_size,
            representation_hidden_size,
            activation,
            layer_norm,
            recurrent_layer_norm,
        )
        latent = stochastic_size * discrete_size + recurrent_state_size
        if self.cnn_keys:
            self.observation_model_cnn = CNNDecoderV2(
                latent,
                {k: cnn_shapes[k] for k in self.cnn_keys},
                cnn_output_side(image_size) ** 2 * cnn_channels_multiplier * 8,
                cnn_channels_multiplier,
                activation,
                layer_norm,
            )
        if self.mlp_keys:
            self.observation_model_mlp = MLPDecoderV2(latent, {k: mlp_shapes[k] for k in self.mlp_keys}, dense_units, mlp_layers, activation, layer_norm)
        head_mlp = lambda: MLP(latent, (dense_units,) * mlp_layers, activation=activation, layer_norm=layer_norm, norm_eps=NORM_EPS)  # noqa: E731
        self.reward_model = head_mlp()
        self.reward_head = Linear(self.reward_model.output_dim, 1)
        if use_continues:
            self.continue_model = head_mlp()
            self.continue_head = Linear(self.continue_model.output_dim, 1)

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
        return self.reward_head(self.reward_model(latent)).float()

    def continues(self, latent: torch.Tensor) -> torch.Tensor:
        return self.continue_head(self.continue_model(latent)).float()

    def dynamic(self, *args, **kwargs):
        return self.rssm.dynamic(*args, **kwargs)

    def imagination(self, *args, **kwargs):
        return self.rssm.imagination(*args, **kwargs)

    def representation(self, recurrent_state, embedded_obs, sample: bool = True, generator=None, draw=None, gumbel=None):
        return self.rssm._representation(recurrent_state, embedded_obs, sample, generator, draw, gumbel)


class ActorV2(DreamerActor):
    """The DreamerV2 policy head: ``trunc_normal`` by default for continuous actions
    (``tanh_normal``, ``normal`` too), a straight-through one-hot without unimix per
    discrete head, no action clip."""

    AUTO_CONTINUOUS = "trunc_normal"
    CONTINUOUS = ("tanh_normal", "normal", "trunc_normal")

    def __init__(
        self,
        latent_size: int,
        actions_dim: Sequence[int],
        is_continuous: bool,
        distribution: str = "auto",
        dense_units: int = 400,
        mlp_layers: int = 4,
        activation: str = "elu",
        layer_norm: bool = False,
        init_std: float = 0.0,
        min_std: float = 0.1,
    ):
        super().__init__(
            latent_size, actions_dim, is_continuous, distribution, dense_units, mlp_layers, unimix=0.0, init_std=init_std,
            min_std=min_std, action_clip=0.0, activation=activation, layer_norm=layer_norm, norm_eps=NORM_EPS,
        )


class MinedojoActorV2(MinedojoMasks, ActorV2):
    """The MineDojo policy of DreamerV2 (and DreamerV1): ``ActorV2``'s trunk and heads,
    masked as ``MinedojoActor``'s."""


def CriticV2(latent_size: int, dense_units: int = 400, mlp_layers: int = 4, activation: str = "elu", layer_norm: bool = False) -> DreamerCritic:
    """The DreamerV2 value head: a dense stack and one Gaussian mean."""
    return DreamerCritic(latent_size, dense_units, mlp_layers, 1, activation, layer_norm, NORM_EPS)


def add_exploration_noise(
    actions: Sequence[torch.Tensor],
    expl_amount: float,
    is_continuous: bool,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[Any]] = None,
) -> Tuple[torch.Tensor, ...]:
    """Exploration noise on the player's actions. Continuous: one action ``clip(a +
    amount * normal, -1, 1)``; discrete: each head's one-hot replaced, where a uniform draw
    falls below ``amount``, by a uniformly drawn one-hot. ``draws`` (injected): continuous
    ``(normal noise [B, A],)``; discrete one ``(gumbel [B, d], uniform [B])`` per head. At
    ``expl_amount <= 0`` the actions come back as they are (the reference draws and
    discards)."""
    if expl_amount <= 0:
        return (torch.cat(actions, -1),) if is_continuous else tuple(actions)
    if is_continuous:
        cat = torch.cat(actions, -1)
        noise = draws[0] if draws is not None else torch.randn(cat.shape, generator=generator, device=cat.device, dtype=cat.dtype)
        return (torch.clamp(cat + expl_amount * noise, -1.0, 1.0),)
    out = []
    for i, act in enumerate(actions):
        gumbel, u = draws[i] if draws is not None else (None, None)
        if gumbel is None:
            gumbel = gumbel_noise(act.shape, act, generator)
            u = torch.rand(act.shape[:1], generator=generator, device=act.device, dtype=act.dtype)
        rand = torch.nn.functional.one_hot(gumbel.argmax(-1), act.shape[-1]).to(act.dtype)
        out.append(torch.where((u < expl_amount)[..., None], rand, act))
    return tuple(out)


# ---------------------------------------------------------------------------
# Initialisation: Xavier-normal kernels, zero biases (reference utils.py init_weights)
# ---------------------------------------------------------------------------


@torch.no_grad()
def xavier_normal_init(module: nn.Module, generator: torch.Generator) -> None:
    """Every kernel Xavier-normal, ``std = sqrt(2 / (fan_in + fan_out))`` with the conv's
    receptive field in both fans; every bias 0; LayerNorms and the GRU cell's
    ``ln_scale``/``ln_bias`` 1 and 0."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            if isinstance(m, nn.Linear):
                fan_in, fan_out = w.shape[1], w.shape[0]
            else:
                rf = w.shape[2] * w.shape[3]
                n_in, n_out = (w.shape[0], w.shape[1]) if isinstance(m, nn.ConvTranspose2d) else (w.shape[1], w.shape[0])
                fan_in, fan_out = rf * n_in, rf * n_out
            w.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, LayerNormGRUCell):
            m.ln_scale.fill_(1.0)
            m.ln_bias.zero_()


def build_agent(
    ctx,
    actions_dim: Sequence[int],
    is_continuous: bool,
    cfg: Dict[str, Any],
    obs_space: spaces.Dict,
):
    """Build the world model, actor, critic and target critic on ``ctx.device``,
    initialised as the reference initialises them, from ``ctx.rng()``, computing in
    ``ctx.compute_dtype`` over float32 parameters.

    Returns ``(world_model, actor, critic, target_critic, latent_size)``."""
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    wm_cfg = cfg.algo.world_model
    act, ln = cfg.algo.dense_act, cfg.algo.layer_norm
    world_model = WorldModelV2(
        cnn_keys=cnn_keys,
        mlp_keys=mlp_keys,
        cnn_shapes={k: tuple(obs_space[k].shape) for k in cnn_keys},
        mlp_shapes={k: tuple(obs_space[k].shape) for k in mlp_keys},
        action_size=int(sum(actions_dim)),
        cnn_channels_multiplier=wm_cfg.encoder.cnn_channels_multiplier,
        dense_units=cfg.algo.dense_units,
        mlp_layers=cfg.algo.mlp_layers,
        stochastic_size=wm_cfg.stochastic_size,
        discrete_size=wm_cfg.discrete_size,
        recurrent_state_size=wm_cfg.recurrent_model.recurrent_state_size,
        transition_hidden_size=wm_cfg.transition_model.hidden_size,
        representation_hidden_size=wm_cfg.representation_model.hidden_size,
        activation=act,
        layer_norm=ln,
        recurrent_layer_norm=wm_cfg.recurrent_model.get("layer_norm", True),
        use_continues=wm_cfg.use_continues,
        image_size=cfg.env.screen_size,
    )
    latent_size = wm_cfg.stochastic_size * wm_cfg.discrete_size + wm_cfg.recurrent_model.recurrent_state_size
    actor = (MinedojoActorV2 if is_minedojo(cfg) else ActorV2)(
        latent_size,
        actions_dim,
        is_continuous,
        distribution=cfg.distribution.get("type", "auto"),
        dense_units=cfg.algo.actor.dense_units,
        mlp_layers=cfg.algo.actor.mlp_layers,
        activation=act,
        layer_norm=ln,
        init_std=cfg.algo.actor.init_std,
        min_std=cfg.algo.actor.min_std,
    )
    critic = CriticV2(latent_size, cfg.algo.critic.dense_units, cfg.algo.critic.mlp_layers, act, ln)
    gen = ctx.rng(device="cpu")
    for m in (world_model, actor, critic):
        xavier_normal_init(m, gen)
    target_critic = CriticV2(latent_size, cfg.algo.critic.dense_units, cfg.algo.critic.mlp_layers, act, ln)
    target_critic.load_state_dict(critic.state_dict())
    modules = [set_compute_dtype(m, ctx.compute_dtype).to(ctx.device) for m in (world_model, actor, critic, target_critic)]
    return (*modules, latent_size)


def make_player_step(world_model: WorldModelV2, actor: ActorV2, actions_dim: Sequence[int], is_continuous: bool):
    """The player step: ``(state, obs, is_first, generator, greedy, draws, expl_amount)``
    -> ``(env_actions, stored_actions, new_state)``.

    ``is_first`` rows restart from zeros. The posterior is sampled even when ``greedy``
    (only the actor is greedy), and exploration noise (``add_exploration_noise``) is added
    unless ``greedy``. ``draws`` (optional) is ``(stochastic one-hot [B, S, D], action
    draws per head, exploration draws)``; any part may be None. ``obs`` entries whose key
    starts with ``mask`` go to the actor."""

    def player_step(
        state: PlayerState,
        obs: Dict[str, torch.Tensor],
        is_first: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        greedy: bool = False,
        draws: Optional[Tuple[Any, Any, Any]] = None,
        expl_amount: float = 0.0,
    ):
        stoch_draw, action_draws, expl_draws = draws if draws is not None else (None, None, None)
        mask = {k: v for k, v in obs.items() if k.startswith("mask")} or None
        embed = world_model.encode(obs)
        keep = 1 - is_first
        recurrent = world_model.rssm.recurrent_model(
            torch.cat([keep * state.stochastic_state, keep * state.actions], -1), keep * state.recurrent_state
        )
        _, stoch_sample = world_model.representation(recurrent, embed, generator=generator, draw=stoch_draw)
        stoch = stoch_sample.flatten(-2)
        actions, _ = actor(torch.cat([stoch, recurrent], -1), generator, greedy, mask, action_draws)
        if not greedy:
            actions = add_exploration_noise(actions, expl_amount, is_continuous, generator, expl_draws)
        stored = torch.cat(actions, -1)
        return actions, stored, PlayerState(recurrent, stoch, stored)

    return player_step
