"""SAC-AE agent (counterpart of ``sheeprl_tpu/algos/sac_ae/agent.py``): pixel SAC with a
convolutional autoencoder.

* ``AEEncoder``: four 3 x 3 convolutions of ``channels`` (strides 2, 1, 1, 1, Flax's
  ``SAME`` padding: at stride 2 on an even size that pads ``(0, 1)``, not ``(1, 1)``),
  ReLU after each, the map flattened in Flax's ``H, W, C`` order, then a dense layer to
  ``latent_dim``, a LayerNorm (Flax's epsilon 1e-6) and tanh.
* ``AEDecoder``: a dense layer to ``channels`` maps of ``screen_size / 2`` squared
  (ReLU), three stride-1 transposed convolutions (ReLU) and a stride-2 one to the
  frame's channels. Flax's ``ConvTranspose`` (``transpose_kernel=False``, ``SAME``)
  correlates the stride-dilated input with its kernel as it stands; torch's
  ``ConvTranspose2d`` flips it, so ``params_from_jax`` flips it when it carries it
  over, and at stride 2 Flax's padding is ``(2, 1)``: torch's padding 0 gives ``(2, 2)``
  and one more row and column, which the decoder cuts off.
* ``AECriticEnsemble``: ``n`` critics of ``dense_units`` x 2 over ``[features,
  action]``, stacked (``sac/agent.py::SACCriticEnsemble``).
* ``SACAEAgent``: the reference's parameter tree as one module; the target encoder and
  the target critic start as copies, not the reference's aliases (``agent.py:150-151``).
* ``preprocess_obs``: the decoder's target, frames reduced to ``bits`` bits in
  ``[-0.5, 0.5)``.

The layers compute in ``mesh.precision``'s dtype (``agent.py:126`` there) over float32
parameters; the encoder's features and the decoder's frames are float32.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.sac.agent import SACActor, SACCriticEnsemble, action_dim, init_agent
from sheeprl_tpu_torch.models.blocks import Conv2d, ConvTranspose2d, LayerNorm, Linear


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """Flax's (and XLA's) ``SAME`` padding of one spatial axis: ``(low, high)``."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class AEEncoder(nn.Module):
    def __init__(self, in_channels: int, latent_dim: int = 50, channels: int = 32, screen_size: int = 64):
        super().__init__()
        self.strides = (2, 1, 1, 1)
        self.convs = nn.ModuleList(Conv2d(c, channels, 3, stride=s) for c, s in zip((in_channels,) + (channels,) * 3, self.strides))
        self.pads = []
        size = screen_size
        for s in self.strides:
            self.pads.append(same_padding(size, 3, s))
            size = math.ceil(size / s)
        self.dense = nn.ModuleList([Linear(size * size * channels, latent_dim)])
        self.norms = nn.ModuleList([LayerNorm(latent_dim, 1e-6)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``[B, C, H, W]`` float in ``[0, 1]`` -> ``[B, latent_dim]`` float32."""
        for conv, (lo, hi) in zip(self.convs, self.pads):
            x = F.relu(conv(F.pad(x, (lo, hi, lo, hi))))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # Flax's H, W, C order
        return torch.tanh(self.norms[0](self.dense[0](x))).float()


class AEDecoder(nn.Module):
    def __init__(self, output_channels: int, latent_dim: int = 50, channels: int = 32, screen_size: int = 64):
        super().__init__()
        self.half, self.channels, self.screen_size = screen_size // 2, channels, screen_size
        self.dense = nn.ModuleList([Linear(latent_dim, self.half * self.half * channels)])
        self.deconvs = nn.ModuleList([ConvTranspose2d(channels, channels, 3, stride=1, padding=1) for _ in range(3)])
        self.deconvs.append(ConvTranspose2d(channels, output_channels, 3, stride=2, padding=0))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """``z``: ``[B, latent_dim]`` -> ``[B, C, H, W]`` float32."""
        x = F.relu(self.dense[0](z))
        x = x.reshape(-1, self.half, self.half, self.channels).permute(0, 3, 1, 2)
        for deconv in self.deconvs[:-1]:
            x = F.relu(deconv(x))
        x = self.deconvs[-1](x)
        return x[..., : 2 * self.half, : 2 * self.half].float()


class AECriticEnsemble(SACCriticEnsemble):
    """``n`` critics of ``hidden_size`` x 2 over ``[features, action]``."""


class SACAEAgent(nn.Module):
    def __init__(self, encoder: AEEncoder, decoder: AEDecoder, critic: nn.Module, actor: SACActor, alpha: float):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.critic = critic
        self.actor = actor
        self.log_alpha = nn.Parameter(torch.tensor(math.log(alpha), dtype=torch.float32))
        self.target_encoder = copy.deepcopy(encoder)
        self.target_critic = copy.deepcopy(critic)

    @torch.no_grad()
    def reset_target(self) -> None:
        for target, source in ((self.target_encoder, self.encoder), (self.target_critic, self.critic)):
            for t, s in zip(target.parameters(), source.parameters()):
                t.copy_(s)


def preprocess_obs(obs: torch.Tensor, bits: int = 5) -> torch.Tensor:
    """Frames (uint8 values) reduced to ``bits`` bits, in ``[-0.5, 0.5)``, float32."""
    bins = 2**bits
    return torch.floor(obs.float() / 2 ** (8 - bits)) / bins - 0.5


def frame_channels(obs_space: Any, cnn_keys: Sequence[str]) -> int:
    return int(sum(np.prod(obs_space[k].shape[:-2]) for k in cnn_keys))


def build_agent(ctx, action_space: Any, obs_space: Any, cfg: Any) -> SACAEAgent:
    act_dim = action_dim(action_space, "SAC-AE")
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    if not cnn_keys:
        raise ValueError("SAC-AE requires at least one cnn key")
    channels = frame_channels(obs_space, cnn_keys)
    size, enc = int(cfg.env.screen_size), cfg.algo.encoder
    encoder = AEEncoder(channels, enc.features_dim, enc.channels, size)
    decoder = AEDecoder(channels, enc.features_dim, enc.channels, size)
    critic = AECriticEnsemble(enc.features_dim + act_dim, cfg.algo.critic.n, cfg.algo.critic.dense_units)
    actor = SACActor(enc.features_dim, act_dim, cfg.algo.actor.dense_units)
    return init_agent(SACAEAgent(encoder, decoder, critic, actor, cfg.algo.alpha.alpha), ctx, ctx.compute_dtype)
