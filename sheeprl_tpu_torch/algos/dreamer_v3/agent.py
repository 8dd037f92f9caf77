"""DreamerV3 agent modules (counterpart of ``sheeprl_tpu/algos/dreamer_v3/agent.py``).

Layout and names follow the reference's parameter tree, so that ``params.py`` carries
a reference checkpoint across by rule. Where the reference's layout differs from
PyTorch's habit, the port keeps the reference's at its public functions:

* observations are channel-first ``[..., C, H, W]`` (uint8 or float) at the encoder's
  input and the decoder's output, as in the reference;
* the conv trunks run NCHW, but each LayerNorm normalises over channels only (channels
  last, as the reference's NHWC LayerNorm does), and the encoder flattens its last
  feature map in ``H, W, C`` order, as the reference's NHWC reshape does, so the
  representation model's first ``Linear`` sees the reference's feature order;
* the decoder's ``latent_proj`` output is read as ``[h0, w0, c0]`` (NHWC) for the same
  reason.

Randomness: every sampling method takes an optional ``torch.Generator`` and an optional
injected one-hot draw (see ``sheeprl_tpu_torch/distributions``).

``DecoupledRSSM`` (``algo.world_model.decoupled_rssm``) reads the posterior from the
embedding alone, so a train step samples the whole ``[T, B]`` posterior in one call and
unrolls only the prior chain. ``MinedojoActor`` (an env whose wrapper's ``_target_``
names minedojo) masks its three heads by the observation's ``mask*`` entries, the
argument heads by the action type it sampled.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.distributions import (
    Normal,
    OneHotCategoricalStraightThrough,
    TanhNormal,
    TruncatedNormal,
    unimix_logits,
)
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.models.blocks import (
    MLP,
    Conv2d,
    ConvTranspose2d,
    LayerNorm,
    LayerNormGRUCell,
    Linear,
    _activation,
    set_compute_dtype,
)
from sheeprl_tpu_torch.utils.utils import symlog


def compute_stochastic_state(
    logits: torch.Tensor,
    discrete: int = 32,
    sample: bool = True,
    generator: Optional[torch.Generator] = None,
    draw: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The ``[..., stoch, discrete]`` one-hot state with straight-through gradients.
    ``draw`` is an injected one-hot sample of that shape, ``gumbel`` injected Gumbel
    noise of that shape."""
    shaped = logits.reshape(*logits.shape[:-1], -1, discrete)
    dist = OneHotCategoricalStraightThrough(shaped)
    return dist.rsample(generator, draw=draw, gumbel=gumbel) if sample else dist.mode


def _channel_norm(norm: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the channels of an NCHW map."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class CNNEncoder(nn.Module):
    """4-stage stride-2 conv trunk (k=4), channels ``m, 2m, 4m, 8m``, optional channel
    LayerNorm, then the activation; flattened in ``H, W, C`` order. ``padding=1``: 64x64
    -> 4x4 (DreamerV3, Flax's SAME); ``padding=0``: 64x64 -> 2x2 (DreamerV2, VALID)."""

    def __init__(
        self,
        in_channels: int,
        channels_multiplier: int = 32,
        stages: int = 4,
        layer_norm: bool = True,
        norm_eps: float = 1e-3,
        activation: str = "silu",
        padding: int = 1,
    ):
        super().__init__()
        chans = [in_channels] + [channels_multiplier * 2**i for i in range(stages)]
        self.convs = nn.ModuleList(
            Conv2d(a, b, 4, stride=2, padding=padding, bias=not layer_norm) for a, b in zip(chans[:-1], chans[1:])
        )
        self.norms = nn.ModuleList(LayerNorm(c, norm_eps) for c in chans[1:]) if layer_norm else None
        self.act = _activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [..., C, H, W] float in [-0.5, 0.5]
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:])
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if self.norms is not None:
                x = _channel_norm(self.norms[i], x)
            x = self.act(x)
        return x.permute(0, 2, 3, 1).reshape(*lead, -1)


class MLPEncoder(nn.Module):
    """symlog -> dense stack."""

    def __init__(self, input_dim: int, dense_units: int = 512, mlp_layers: int = 2, layer_norm: bool = True, norm_eps: float = 1e-3):
        super().__init__()
        self.mlp = MLP(input_dim, (dense_units,) * mlp_layers, activation="silu", layer_norm=layer_norm, norm_eps=norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(symlog(x))


class Encoder(nn.Module):
    def __init__(
        self,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_shapes: Dict[str, Tuple[int, ...]],
        mlp_shapes: Dict[str, Tuple[int, ...]],
        cnn_channels_multiplier: int = 32,
        cnn_stages: int = 4,
        dense_units: int = 512,
        mlp_layers: int = 2,
        layer_norm: bool = True,
        image_size: int = 64,
    ):
        super().__init__()
        self.cnn_keys = list(cnn_keys)
        self.mlp_keys = list(mlp_keys)
        self.output_dim = 0
        if self.cnn_keys:
            in_ch = sum(int(cnn_shapes[k][0]) for k in self.cnn_keys)
            self.cnn_encoder = CNNEncoder(in_ch, cnn_channels_multiplier, cnn_stages, layer_norm)
            side = image_size // 2**cnn_stages
            self.output_dim += side * side * cnn_channels_multiplier * 2 ** (cnn_stages - 1)
        if self.mlp_keys:
            in_dim = sum(int(np.prod(mlp_shapes[k])) for k in self.mlp_keys)
            self.mlp_encoder = MLPEncoder(in_dim, dense_units, mlp_layers, layer_norm)
            self.output_dim += dense_units

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.cnn_keys:
            imgs = []
            for k in self.cnn_keys:
                img = obs[k]
                img = img.float() / 255.0 - 0.5 if img.dtype == torch.uint8 else img.float()
                imgs.append(img)
            feats.append(self.cnn_encoder(torch.cat(imgs, -3)))
        if self.mlp_keys:
            feats.append(self.mlp_encoder(torch.cat([obs[k].float() for k in self.mlp_keys], -1)))
        return torch.cat(feats, -1).float()


class CNNDecoder(nn.Module):
    """Latent -> stacked image reconstruction, the encoder's mirror. Output is
    channel-first, split per key."""

    def __init__(
        self,
        latent_size: int,
        output_shapes: Dict[str, Tuple[int, ...]],
        channels_multiplier: int = 32,
        stages: int = 4,
        layer_norm: bool = True,
        norm_eps: float = 1e-3,
        image_size: int = 64,
    ):
        super().__init__()
        self.output_shapes = dict(output_shapes)
        total_c = sum(int(s[0]) for s in self.output_shapes.values())
        self.h0 = image_size // 2**stages
        self.c0 = channels_multiplier * 2 ** (stages - 1)
        self.latent_proj = Linear(latent_size, self.h0 * self.h0 * self.c0)
        chans = [self.c0] + [channels_multiplier * 2**i for i in reversed(range(stages - 1))]
        # Flax's ConvTranspose(k=4, s=2, padding="SAME") pads the stride-dilated input by
        # 2 on each side, as ConvTranspose2d(k=4, s=2, padding=1) does; params.py flips
        # the carried kernel, since torch's transposed conv flips it and Flax's does not.
        self.deconvs = nn.ModuleList(
            ConvTranspose2d(a, b, 4, stride=2, padding=1, bias=not layer_norm) for a, b in zip(chans[:-1], chans[1:])
        )
        self.norms = nn.ModuleList(LayerNorm(c, norm_eps) for c in chans[1:]) if layer_norm else None
        self.head = ConvTranspose2d(chans[-1], total_c, 4, stride=2, padding=1)

    def forward(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.latent_proj(z)
        lead = x.shape[:-1]
        x = x.reshape(-1, self.h0, self.h0, self.c0).permute(0, 3, 1, 2)
        for i, deconv in enumerate(self.deconvs):
            x = deconv(x)
            if self.norms is not None:
                x = _channel_norm(self.norms[i], x)
            x = F.silu(x)
        x = self.head(x).float()
        x = x.reshape(*lead, *x.shape[-3:])
        out, offset = {}, 0
        for k, shape in self.output_shapes.items():
            out[k] = x[..., offset : offset + shape[0], :, :]
            offset += shape[0]
        return out


class MLPDecoder(nn.Module):
    """Latent -> per-key vector reconstructions."""

    def __init__(self, latent_size: int, output_shapes: Dict[str, Tuple[int, ...]], dense_units: int = 512, mlp_layers: int = 2, layer_norm: bool = True):
        super().__init__()
        self.mlp = MLP(latent_size, (dense_units,) * mlp_layers, activation="silu", layer_norm=layer_norm, norm_eps=1e-3)
        self.heads = nn.ModuleDict({k: Linear(dense_units, int(np.prod(s))) for k, s in output_shapes.items()})

    def forward(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.mlp(z)
        return {k: head(x).float() for k, head in self.heads.items()}


class RecurrentModel(nn.Module):
    """Dense + LN + SiLU -> LayerNormGRUCell."""

    def __init__(self, input_size: int, recurrent_state_size: int, dense_units: int = 512):
        super().__init__()
        self.input_proj = MLP(input_size, (dense_units,), activation="silu", layer_norm=True, norm_eps=1e-3)
        self.rnn = LayerNormGRUCell(dense_units, recurrent_state_size)

    def forward(self, x: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.rnn(recurrent_state, self.input_proj(x)).float()


class RSSM(nn.Module):
    """Recurrent State-Space Model. ``dynamic``/``imagination`` take injected one-hot
    draws or Gumbel noise in place of the generator's."""

    def __init__(
        self,
        embed_size: int,
        action_size: int,
        stochastic_size: int = 32,
        discrete_size: int = 32,
        recurrent_state_size: int = 512,
        dense_units: int = 512,
        transition_hidden_size: int = 512,
        representation_hidden_size: int = 512,
        unimix: float = 0.01,
        learnable_initial_recurrent_state: bool = True,
    ):
        super().__init__()
        self.stochastic_size = stochastic_size
        self.discrete_size = discrete_size
        self.recurrent_state_size = recurrent_state_size
        self.unimix = unimix
        stoch_out = stochastic_size * discrete_size
        self.recurrent_model = RecurrentModel(stoch_out + action_size, recurrent_state_size, dense_units)
        self.representation_model = MLP(
            self._representation_input(embed_size), (representation_hidden_size,), activation="silu", layer_norm=True, norm_eps=1e-3
        )
        self.repr_logits = Linear(representation_hidden_size, stoch_out)
        self.transition_model = MLP(recurrent_state_size, (transition_hidden_size,), activation="silu", layer_norm=True, norm_eps=1e-3)
        self.trans_logits = Linear(transition_hidden_size, stoch_out)
        if learnable_initial_recurrent_state:
            self.initial_recurrent_state = nn.Parameter(torch.zeros(recurrent_state_size))
        else:
            self.register_buffer("initial_recurrent_state", torch.zeros(recurrent_state_size), persistent=False)

    def _representation_input(self, embed_size: int) -> int:
        return self.recurrent_state_size + embed_size

    def _uniform_mix(self, logits: torch.Tensor) -> torch.Tensor:
        shaped = logits.reshape(*logits.shape[:-1], self.stochastic_size, self.discrete_size)
        return unimix_logits(shaped, self.unimix).reshape(logits.shape)

    def _representation(self, recurrent_state, embedded_obs, sample: bool = True, generator=None, draw=None, gumbel=None):
        x = self.representation_model(torch.cat([recurrent_state, embedded_obs], -1))
        logits = self._uniform_mix(self.repr_logits(x).float())
        return logits, compute_stochastic_state(logits, self.discrete_size, sample, generator, draw, gumbel)

    def _transition(self, recurrent_state, sample: bool = True, generator=None, draw=None, gumbel=None):
        logits = self._uniform_mix(self.trans_logits(self.transition_model(recurrent_state)).float())
        return logits, compute_stochastic_state(logits, self.discrete_size, sample, generator, draw, gumbel)

    def get_initial_states(self, batch_shape: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """tanh'd learnable initial recurrent state and its prior's mode."""
        h0 = torch.tanh(self.initial_recurrent_state).expand(*batch_shape, self.recurrent_state_size)
        _, z0 = self._transition(h0, sample=False)
        return h0, z0.reshape(*batch_shape, -1)

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
        """One posterior step: ``is_first`` rows restart from the learned initial state,
        then GRU -> prior -> posterior. ``draws`` = (prior one-hot, posterior one-hot);
        ``gumbels`` = (prior Gumbel noise, posterior Gumbel noise), ``[B, stoch,
        discrete]`` each."""
        prior_draw, post_draw = draws if draws is not None else (None, None)
        prior_gumbel, post_gumbel = gumbels if gumbels is not None else (None, None)
        action = (1 - is_first) * action
        h0, z0 = self.get_initial_states(recurrent_state.shape[:-1])
        recurrent_state = (1 - is_first) * recurrent_state + is_first * h0
        posterior = (1 - is_first) * posterior + is_first * z0
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], -1), recurrent_state)
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
        """One prior-only step."""
        recurrent_state = self.recurrent_model(torch.cat([prior, actions], -1), recurrent_state)
        _, imagined = self._transition(recurrent_state, generator=generator, draw=draw, gumbel=gumbel)
        return imagined.flatten(-2), recurrent_state


class DecoupledRSSM(RSSM):
    """The RSSM whose posterior reads the observation's embedding alone, ``q(z_t | o_t)``:
    the representation model's input is the embedding, and ``dynamic`` is a prior-only
    step from the previous posterior."""

    def _representation_input(self, embed_size: int) -> int:
        return embed_size

    def _representation(self, embedded_obs, sample: bool = True, generator=None, draw=None, gumbel=None):  # type: ignore[override]
        logits = self._uniform_mix(self.repr_logits(self.representation_model(embedded_obs)).float())
        return logits, compute_stochastic_state(logits, self.discrete_size, sample, generator, draw, gumbel)

    def dynamic(  # type: ignore[override]
        self,
        posterior: torch.Tensor,
        recurrent_state: torch.Tensor,
        action: torch.Tensor,
        is_first: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        draw: Optional[torch.Tensor] = None,
        gumbel: Optional[torch.Tensor] = None,
    ):
        """One prior-only step from ``posterior``, the previous step's (already sampled
        from its embedding): ``is_first`` rows restart from the learned initial state,
        then GRU -> prior. Returns ``(recurrent_state, prior, prior_logits)``."""
        action = (1 - is_first) * action
        h0, z0 = self.get_initial_states(recurrent_state.shape[:-1])
        recurrent_state = (1 - is_first) * recurrent_state + is_first * h0
        posterior = (1 - is_first) * posterior + is_first * z0
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], -1), recurrent_state)
        prior_logits, prior = self._transition(recurrent_state, generator=generator, draw=draw, gumbel=gumbel)
        return recurrent_state, prior, prior_logits


class WorldModel(nn.Module):
    """Encoder + RSSM + decoders + reward/continue heads."""

    def __init__(
        self,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_shapes: Dict[str, Tuple[int, ...]],
        mlp_shapes: Dict[str, Tuple[int, ...]],
        action_size: int,
        cnn_channels_multiplier: int = 32,
        dense_units: int = 512,
        mlp_layers: int = 2,
        stochastic_size: int = 32,
        discrete_size: int = 32,
        recurrent_state_size: int = 512,
        transition_hidden_size: int = 512,
        representation_hidden_size: int = 512,
        unimix: float = 0.01,
        reward_bins: int = 255,
        image_size: int = 64,
        learnable_initial_recurrent_state: bool = True,
        decoupled_rssm: bool = False,
    ):
        super().__init__()
        self.cnn_keys = list(cnn_keys)
        self.mlp_keys = list(mlp_keys)
        self.decoupled_rssm = decoupled_rssm
        self.encoder = Encoder(
            cnn_keys, mlp_keys, cnn_shapes, mlp_shapes, cnn_channels_multiplier, 4, dense_units, mlp_layers, image_size=image_size
        )
        self.rssm = (DecoupledRSSM if decoupled_rssm else RSSM)(
            self.encoder.output_dim,
            action_size,
            stochastic_size,
            discrete_size,
            recurrent_state_size,
            dense_units,
            transition_hidden_size,
            representation_hidden_size,
            unimix,
            learnable_initial_recurrent_state,
        )
        latent = stochastic_size * discrete_size + recurrent_state_size
        if self.cnn_keys:
            self.observation_model_cnn = CNNDecoder(
                latent, {k: cnn_shapes[k] for k in self.cnn_keys}, cnn_channels_multiplier, image_size=image_size
            )
        if self.mlp_keys:
            self.observation_model_mlp = MLPDecoder(latent, {k: mlp_shapes[k] for k in self.mlp_keys}, dense_units, mlp_layers)
        head_mlp = lambda: MLP(latent, (dense_units,) * mlp_layers, activation="silu", layer_norm=True, norm_eps=1e-3)  # noqa: E731
        self.reward_model = head_mlp()
        self.reward_head = Linear(dense_units, reward_bins)
        self.continue_model = head_mlp()
        self.continue_head = Linear(dense_units, 1)

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

    def initial_states(self, batch_shape):
        return self.rssm.get_initial_states(batch_shape)

    def representation(self, recurrent_state, embedded_obs, sample: bool = True, generator=None, draw=None, gumbel=None):
        """The posterior of ``embedded_obs`` (and, unless decoupled, ``recurrent_state``)."""
        if self.decoupled_rssm:
            return self.rssm._representation(embedded_obs, sample, generator, draw, gumbel)
        return self.rssm._representation(recurrent_state, embedded_obs, sample, generator, draw, gumbel)

    def representation_from_embed(self, embedded_obs, sample: bool = True, generator=None, draw=None, gumbel=None):
        """The posterior of a whole ``[T, B]`` batch of embeddings in one call
        (``DecoupledRSSM`` only)."""
        return self.rssm._representation(embedded_obs, sample, generator, draw, gumbel)


class DreamerActor(nn.Module):
    """Policy head over latent states. The discrete head samples a straight-through
    one-hot per action dimension; the continuous heads follow ``distribution``
    (``auto``: ``AUTO_CONTINUOUS``, one of ``CONTINUOUS``)."""

    AUTO_CONTINUOUS = "scaled_normal"
    CONTINUOUS = ("tanh_normal", "normal", "trunc_normal", "scaled_normal")

    def __init__(
        self,
        latent_size: int,
        actions_dim: Sequence[int],
        is_continuous: bool,
        distribution: str = "auto",
        dense_units: int = 512,
        mlp_layers: int = 2,
        unimix: float = 0.01,
        init_std: float = 2.0,
        min_std: float = 0.1,
        max_std: float = 1.0,
        action_clip: float = 1.0,
        activation: str = "silu",
        layer_norm: bool = True,
        norm_eps: float = 1e-3,
    ):
        super().__init__()
        if distribution == "auto":
            distribution = self.AUTO_CONTINUOUS if is_continuous else "discrete"
        supported = self.CONTINUOUS if is_continuous else ("discrete",)
        if distribution not in supported:
            raise ValueError(f"distribution.type={distribution!r} not supported for this action space; use one of {supported}")
        self.distribution = distribution
        self.actions_dim = tuple(int(a) for a in actions_dim)
        self.is_continuous = is_continuous
        self.unimix = unimix
        self.init_std = init_std
        self.min_std = min_std
        self.max_std = max_std
        self.action_clip = action_clip
        self.mlp = MLP(latent_size, (dense_units,) * mlp_layers, activation=activation, layer_norm=layer_norm, norm_eps=norm_eps)
        if is_continuous:
            self.head = Linear(dense_units, 2 * sum(self.actions_dim))
        else:
            self.heads = nn.ModuleList(Linear(dense_units, d) for d in self.actions_dim)

    def forward(
        self,
        state: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        greedy: bool = False,
        mask: Optional[Dict[str, torch.Tensor]] = None,
        draws: Optional[Sequence[torch.Tensor]] = None,
        gumbels: Optional[Sequence[torch.Tensor]] = None,
    ):
        """Returns ``(actions, dists)``, one per action head. ``draws`` are injected
        samples: one-hots for the discrete heads, standard-normal (or, for
        ``trunc_normal``, uniform) noise for the continuous head; ``gumbels`` injected
        Gumbel noise for the discrete heads."""
        x = self.mlp(state)
        if self.is_continuous:
            mean, std = self.head(x).float().chunk(2, -1)
            if self.distribution == "tanh_normal":
                mean = 5 * torch.tanh(mean / 5)
                std = F.softplus(std + self.init_std) + self.min_std
                dist = TanhNormal(mean, std)
            elif self.distribution == "normal":
                dist = Normal(mean, std)
            elif self.distribution == "trunc_normal":
                std = 2 * torch.sigmoid((std + self.init_std) / 2) + self.min_std
                dist = TruncatedNormal(torch.tanh(mean), std, -1.0, 1.0)
            else:  # scaled_normal
                std = (self.max_std - self.min_std) * torch.sigmoid(std + self.init_std) + self.min_std
                dist = Normal(torch.tanh(mean), std)
            sampled = not greedy and (generator is not None or draws is not None)
            actions = dist.rsample(generator, noise=draws[0] if draws is not None else None) if sampled else dist.mode
            if self.action_clip > 0:
                clip = torch.full_like(actions, self.action_clip)
                actions = actions * (clip / torch.maximum(clip, actions.abs())).detach()
            return (actions,), (dist,)
        actions, dists = [], []
        for i, head in enumerate(self.heads):
            d = OneHotCategoricalStraightThrough(self._masked(i, unimix_logits(head(x).float(), self.unimix), mask, actions))
            dists.append(d)
            draw = draws[i] if draws is not None else None
            gumbel = gumbels[i] if gumbels is not None else None
            sampled = not greedy and (generator is not None or draw is not None or gumbel is not None)
            actions.append(d.rsample(generator, draw=draw, gumbel=gumbel) if sampled else d.mode)
        return tuple(actions), tuple(dists)

    def _masked(self, i: int, logits: torch.Tensor, mask, actions) -> torch.Tensor:
        """Discrete head ``i``'s logits under the observation's masks, given the heads
        sampled before it: as they are (``MinedojoActor`` masks them)."""
        return logits


def minedojo_mask(i: int, logits: torch.Tensor, mask: Dict[str, torch.Tensor], functional_action: Optional[torch.Tensor]) -> torch.Tensor:
    """Head ``i``'s logits with its disallowed entries at float32's lowest value: the action
    type by ``mask_action_type``; the craft argument by ``mask_craft_smelt`` where the
    sampled action type (``functional_action``) is 15 (craft); the item argument by
    ``mask_equip_place`` where it is 16 or 17 (equip, place) and by ``mask_destroy`` where
    it is 18 (destroy). Elsewhere an argument head is left free."""
    lowest = torch.finfo(torch.float32).min
    if i == 0:
        allowed = mask["mask_action_type"]
    elif i == 1:
        allowed = torch.where((functional_action == 15)[..., None], mask["mask_craft_smelt"], True)
    else:
        equip_place = ((functional_action == 16) | (functional_action == 17))[..., None]
        allowed = torch.where(equip_place, mask["mask_equip_place"], True)
        allowed = torch.where((functional_action == 18)[..., None], mask["mask_destroy"], allowed)
    return torch.where(allowed.bool(), logits, torch.full_like(logits, lowest))


class MinedojoMasks:
    """The MineDojo policy's heads (action type, craft argument, item argument), each
    masked after unimix (``minedojo_mask``) and sampled in order, since the argument
    heads' masks read the action type sampled first; injected draws are consumed head by
    head. Mixed into an actor class of discrete heads."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.is_continuous:
            raise ValueError(f"{type(self).__name__} only supports the functional MultiDiscrete action space")

    def _masked(self, i: int, logits: torch.Tensor, mask, actions) -> torch.Tensor:
        if mask is None:
            return logits
        return minedojo_mask(i, logits, mask, actions[0].argmax(-1) if actions else None)


class MinedojoActor(MinedojoMasks, DreamerActor):
    """DreamerV3's MineDojo policy: ``DreamerActor``'s trunk and heads, masked."""


class DreamerCritic(nn.Module):
    """Value head: ``bins`` two-hot logits (DreamerV3) or one Gaussian mean (``bins=1``,
    DreamerV2)."""

    def __init__(
        self,
        latent_size: int,
        dense_units: int = 512,
        mlp_layers: int = 2,
        bins: int = 255,
        activation: str = "silu",
        layer_norm: bool = True,
        norm_eps: float = 1e-3,
    ):
        super().__init__()
        self.mlp = MLP(latent_size, (dense_units,) * mlp_layers, activation=activation, layer_norm=layer_norm, norm_eps=norm_eps)
        self.head = Linear(dense_units, bins)

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        return self.head(self.mlp(state)).float()


# ---------------------------------------------------------------------------
# Initialisation: Flax's defaults, then Hafner's (reference agent.py:649-689)
# ---------------------------------------------------------------------------


def _flax_fans(module: nn.Module) -> Tuple[int, int, int]:
    """(lecun fan_in, Hafner's shape[0], Hafner's shape[-1]) of a layer's weight, read
    as Flax lays the kernel out: Dense ``[in, out]``, Conv/ConvTranspose ``[kh, kw, in, out]``."""
    w = module.weight
    if isinstance(module, nn.Linear):
        return w.shape[1], w.shape[1], w.shape[0]
    kh, kw = w.shape[-2:]
    if isinstance(module, nn.ConvTranspose2d):  # torch [in, out, kh, kw]
        return w.shape[0] * kh * kw, kh, w.shape[1]
    return w.shape[1] * kh * kw, kh, w.shape[0]  # Conv2d: torch [out, in, kh, kw]


@torch.no_grad()
def flax_default_init(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's defaults: kernels truncated lecun-normal (``std = sqrt(1/fan_in) / .8796``,
    cut at two std), biases 0, LayerNorm scale 1 and bias 0, ``ln_scale`` 1,
    ``ln_bias`` 0, the learnable initial recurrent state 0."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = _flax_fans(m)[0]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, LayerNormGRUCell):
            m.ln_scale.fill_(1.0)
            m.ln_bias.zero_()
        elif isinstance(m, RSSM):
            m.initial_recurrent_state.zero_()


_UNIFORM_HEADS = {"repr_logits", "trans_logits", "continue_head", "head"}


@torch.no_grad()
def apply_hafner_init(module: nn.Module, generator: torch.Generator) -> None:
    """Uniform(scale=1) re-init of the output heads' weights: the RSSM logits heads,
    the continue head, every ``head`` and every entry of ``heads``. As in the
    reference, the limit is ``sqrt(3 / ((shape[0] + shape[-1]) / 2))`` of the Flax
    kernel's shape, and biases are left as they are."""
    for name, m in module.named_modules():
        parts = name.split(".")
        is_head = parts[-1] in _UNIFORM_HEADS or (len(parts) >= 2 and parts[-2] == "heads")
        if is_head and isinstance(m, (nn.Linear, nn.ConvTranspose2d)):
            _, first, last = _flax_fans(m)
            limit = math.sqrt(3.0 / ((first + last) / 2.0))
            m.weight.uniform_(-limit, limit, generator=generator)


@torch.no_grad()
def zero_init_head(head: nn.Module) -> None:
    """Zero an output head's weight and bias (critic and reward heads)."""
    head.weight.zero_()
    head.bias.zero_()


# ---------------------------------------------------------------------------
# Player: explicit carried state (reference agent.py:697-829)
# ---------------------------------------------------------------------------


class PlayerState(NamedTuple):
    recurrent_state: torch.Tensor  # [n_envs, R]
    stochastic_state: torch.Tensor  # [n_envs, S*D]
    actions: torch.Tensor  # [n_envs, sum(actions_dim)]


def parse_actions_dim(action_space: spaces.Space) -> Tuple[bool, Tuple[int, ...]]:
    if isinstance(action_space, spaces.Box):
        return True, (int(np.prod(action_space.shape)),)
    if isinstance(action_space, spaces.Discrete):
        return False, (int(action_space.n),)
    if isinstance(action_space, spaces.MultiDiscrete):
        return False, tuple(int(n) for n in action_space.nvec)
    raise ValueError(f"Unsupported action space: {type(action_space)}")


def is_minedojo(cfg: Dict[str, Any]) -> bool:
    """Whether the env is MineDojo's (its wrapper's ``_target_`` names it): the actor is
    then the masked one."""
    return "minedojo" in str(cfg.env.get("wrapper", {}).get("_target_", "")).lower()


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
    world_model = WorldModel(
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
        unimix=cfg.algo.unimix,
        reward_bins=wm_cfg.reward_model.bins,
        image_size=cfg.env.screen_size,
        learnable_initial_recurrent_state=wm_cfg.learnable_initial_recurrent_state,
        decoupled_rssm=wm_cfg.get("decoupled_rssm", False),
    )
    latent_size = wm_cfg.stochastic_size * wm_cfg.discrete_size + wm_cfg.recurrent_model.recurrent_state_size
    actor = (MinedojoActor if is_minedojo(cfg) else DreamerActor)(
        latent_size,
        actions_dim,
        is_continuous,
        distribution=cfg.distribution.get("type", "auto"),
        dense_units=cfg.algo.actor.dense_units,
        mlp_layers=cfg.algo.actor.mlp_layers,
        unimix=cfg.algo.actor.unimix,
        init_std=cfg.algo.actor.init_std,
        min_std=cfg.algo.actor.min_std,
        max_std=cfg.algo.actor.max_std,
        action_clip=cfg.algo.actor.action_clip,
    )
    critic = DreamerCritic(latent_size, cfg.algo.critic.dense_units, cfg.algo.critic.mlp_layers, cfg.algo.critic.bins)
    gen = ctx.rng(device="cpu")
    for m in (world_model, actor, critic):
        flax_default_init(m, gen)
    if cfg.algo.hafner_initialization:
        apply_hafner_init(world_model, gen)
        zero_init_head(world_model.reward_head)
        apply_hafner_init(actor, gen)
        zero_init_head(critic.head)
    target_critic = DreamerCritic(latent_size, cfg.algo.critic.dense_units, cfg.algo.critic.mlp_layers, cfg.algo.critic.bins)
    target_critic.load_state_dict(critic.state_dict())
    modules = [set_compute_dtype(m, ctx.compute_dtype).to(ctx.device) for m in (world_model, actor, critic, target_critic)]
    return (*modules, latent_size)


def make_player_step(world_model: WorldModel, actor: DreamerActor, actions_dim: Sequence[int], discrete_size: int):
    """The player step: ``(state, obs, is_first, generator, greedy, draws)`` ->
    ``(env_actions, stored_actions, new_state)``.

    The posterior is sampled even when ``greedy`` (only the actor is greedy), as in
    the reference. ``draws`` (optional) is ``(stochastic one-hot [B, S, D], action
    draws per head)``; either part may be None. ``obs`` entries whose key starts with
    ``mask`` go to the actor."""

    def player_step(
        state: PlayerState,
        obs: Dict[str, torch.Tensor],
        is_first: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        greedy: bool = False,
        draws: Optional[Tuple[Optional[torch.Tensor], Optional[Sequence[torch.Tensor]]]] = None,
    ):
        stoch_draw, action_draws = draws if draws is not None else (None, None)
        mask = {k: v for k, v in obs.items() if k.startswith("mask")} or None
        embed = world_model.encode(obs)
        h0, z0 = world_model.initial_states(state.recurrent_state.shape[:-1])
        recurrent = (1 - is_first) * state.recurrent_state + is_first * h0
        stoch = (1 - is_first) * state.stochastic_state + is_first * z0
        prev_actions = (1 - is_first) * state.actions
        recurrent = world_model.rssm.recurrent_model(torch.cat([stoch, prev_actions], -1), recurrent)
        _, stoch_sample = world_model.representation(recurrent, embed, generator=generator, draw=stoch_draw)
        stoch = stoch_sample.flatten(-2)
        latent = torch.cat([stoch, recurrent], -1)
        actions, _ = actor(latent, generator, greedy, mask, action_draws)
        stored = torch.cat(actions, -1)
        return actions, stored, PlayerState(recurrent, stoch, stored)

    return player_step
