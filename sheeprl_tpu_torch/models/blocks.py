"""Reusable ``torch.nn`` building blocks (counterpart of ``sheeprl_tpu/models/blocks.py``).

* ``Linear``, ``Conv2d``, ``ConvTranspose2d``: ``torch.nn``'s layers with a compute
  dtype, as Flax's ``dtype=`` argument gives one (see below).
* ``MLP``: dense stack with optional per-layer LayerNorm.
* ``LayerNorm``: LayerNorm over the last axis with Flax's statistics (see below).
* ``LayerNormGRUCell``: GRU with LayerNorm on the fused ``[x, h]`` projection and
  Hafner's ``update - 1`` bias; its gate step is the ``layernorm_gru`` kernel on CUDA.
* ``CNN``: a conv stack over NCHW input (the reference's is NHWC), optional channel
  LayerNorm; ``cnn_obs_to_nhwc``: uint8 frames (frame-stacked or not) to the
  reference's NHWC float input in [-0.5, 0.5].
* ``MultiEncoder``: the PPO family's encoder of dict observations, one conv trunk
  over the channel-concatenated image keys (the Nature CNN at its defaults) and one
  dense trunk over the concatenated vector keys.

Parameters are float32. Each layer computes in its ``compute_dtype`` (float32 unless
``set_compute_dtype`` says otherwise): the input and the parameters are cast to it and
the output has it, as Flax's ``Dense``/``Conv``/``ConvTranspose`` with ``dtype=bfloat16``
over float32 parameters do. Explicit casts in the layers, not ``torch.autocast``, whose
per-operation rules differ from Flax's per-module dtype.

Child names follow the reference's parameter tree (``dense.<i>`` for ``Dense_<i>``,
``norms.<i>`` for ``LayerNorm_<i>``), so that ``algos/dreamer_v3/params.py`` can carry a
reference checkpoint across by rule.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.ops.gru import layernorm_gru


def _activation(act: str | Callable | None) -> Optional[Callable]:
    if act is None or callable(act):
        return act
    table = {
        "relu": F.relu,
        "tanh": torch.tanh,
        "silu": F.silu,
        "swish": F.silu,
        "elu": F.elu,
        # flax.linen.gelu defaults to the tanh approximation
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "leaky_relu": F.leaky_relu,
        "identity": None,
        "none": None,
    }
    return table[str(act).lower()]


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor], channel_dim: int) -> torch.Tensor:
    """Flax rounds the product to the compute dtype, then adds the bias in it: two
    roundings, which a fused bias would make one. The second matters in bfloat16, where
    a categorical mode whose top logits tie to within a rounding otherwise picks another
    class than the reference."""
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[channel_dim] = -1
    return y + bias.to(y.dtype).reshape(shape)


class Linear(nn.Linear):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:  # parameters cast down (a bf16 serving tier) compute in float32 too
            return F.linear(x.float(), self.weight.float(), None if self.bias is None else self.bias.float())
        return _add_bias(F.linear(x.to(dt), self.weight.to(dt)), self.bias, -1)


class Conv2d(nn.Conv2d):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return self._conv_forward(x.float(), self.weight.float(), None if self.bias is None else self.bias.float())
        return _add_bias(self._conv_forward(x.to(dt), self.weight.to(dt), None), self.bias, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        args = (self.stride, self.padding, self.output_padding, self.groups, self.dilation)
        if dt == torch.float32:
            return F.conv_transpose2d(x.float(), self.weight, self.bias, *args)
        return _add_bias(F.conv_transpose2d(x.to(dt), self.weight.to(dt), None, *args), self.bias, 1)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, computed as ``flax.linen.LayerNorm`` computes it.

    Flax (0.12, ``use_fast_variance=True``) takes the statistics in float32 whatever
    its ``dtype``: the variance as ``E[x^2] - E[x]^2``, clipped at 0, then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, cast to ``dtype``
    (here ``compute_dtype``) at the end. The port keeps that order so carried weights
    give the reference's outputs; the GRU cell's own LayerNorm is the two-pass form
    (``ops/gru.py``)."""

    compute_dtype = torch.float32

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_layer_norm(x, self.weight, self.bias, self.eps, self.compute_dtype)


def flax_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """``LayerNorm``'s arithmetic over the last axis of ``x``; ``weight`` and ``bias``
    broadcast against ``x``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * weight)
    return (y + bias).to(dtype)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set the compute dtype of every layer in ``module`` (Flax's ``dtype=``); the
    parameters stay as they are."""
    for m in module.modules():
        if hasattr(type(m), "compute_dtype"):  # Linear, Conv2d, ConvTranspose2d, LayerNorm and their stacked kin
            m.compute_dtype = dtype
    return module


class MLP(nn.Module):
    def __init__(
        self,
        input_dim: int,
        hidden_sizes: Sequence[int] = (),
        output_dim: Optional[int] = None,
        activation: str | Callable = "tanh",
        layer_norm: bool = False,
        norm_eps: float = 1e-5,
    ):
        super().__init__()
        self.act = _activation(activation)
        sizes = [input_dim, *hidden_sizes]
        self.dense = nn.ModuleList(Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.norms = nn.ModuleList(LayerNorm(s, norm_eps) for s in hidden_sizes) if layer_norm else None
        if output_dim is not None:
            self.dense.append(Linear(sizes[-1], output_dim))
        self.n_hidden = len(hidden_sizes)
        self.output_dim = output_dim if output_dim is not None else sizes[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.dense):
            x = layer(x)
            if i < self.n_hidden:
                if self.norms is not None:
                    x = self.norms[i](x)
                if self.act is not None:
                    x = self.act(x)
        return x


class LayerNormGRUCell(nn.Module):
    """GRU cell with LayerNorm on the fused projection (reference ``blocks.py:157-203``).

    One bias-free ``Linear`` maps ``concat([x, h])`` to ``3H`` laid out as
    ``[reset, cand, update]``; ``ln_scale``/``ln_bias`` (``[3H]``) are the LayerNorm's
    parameters. The gate step is ``ops.gru.layernorm_gru``: the CUDA kernels for CUDA
    tensors, the plain version on the CPU. It takes the projection and the state in the
    compute dtype and returns the new state in it."""

    def __init__(self, input_size: int, hidden_size: int, norm_eps: float = 1e-3):
        super().__init__()
        self.hidden_size = hidden_size
        self.norm_eps = norm_eps
        self.linear = Linear(input_size + hidden_size, 3 * hidden_size, bias=False)
        self.ln_scale = nn.Parameter(torch.ones(3 * hidden_size))
        self.ln_bias = nn.Parameter(torch.zeros(3 * hidden_size))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hidden = self.hidden_size
        fused = self.linear(torch.cat([x, h], -1))
        out = layernorm_gru(
            fused.reshape(-1, 3 * hidden).contiguous(),
            h.reshape(-1, hidden).to(fused.dtype).contiguous(),
            self.ln_scale,
            self.ln_bias,
            self.norm_eps,
        )
        return out.reshape(*h.shape[:-1], hidden)


def cnn_obs_to_nhwc(x: torch.Tensor, stacked: bool = False) -> torch.Tensor:
    """``[..., C, H, W]`` (or ``[..., S, C, H, W]`` when ``stacked``) uint8 ->
    ``[..., H, W, S*C]`` float in [-0.5, 0.5], as the reference's function of the same
    name. The port's convs take ``cnn_obs_to_nchw``'s layout; this one is what the
    reference feeds its NHWC convs."""
    return cnn_obs_to_nchw(x, stacked).movedim(-3, -1)


def cnn_obs_to_nchw(x: torch.Tensor, stacked: bool = False) -> torch.Tensor:
    """``[..., C, H, W]`` (or ``[..., S, C, H, W]``) uint8 -> ``[..., S*C, H, W]`` float
    in [-0.5, 0.5]: a frame stack ``S`` folds into the channels, stack-major."""
    if x.dtype == torch.uint8:
        x = x.float() / 255.0 - 0.5
    if stacked:
        x = x.reshape(*x.shape[:-4], x.shape[-4] * x.shape[-3], *x.shape[-2:])
    return x


class CNN(nn.Module):
    """Conv stack over NCHW input (reference ``blocks.py:75``, NHWC there):
    ``channels[i]`` with ``kernels[i]``/``strides[i]``/``paddings[i]`` (an int, or
    ``VALID`` = 0), each conv followed by the optional LayerNorm over its channels and
    the activation."""

    def __init__(
        self,
        in_channels: int,
        channels: Sequence[int],
        kernels: Sequence[int] = (4,),
        strides: Sequence[int] = (2,),
        paddings: Sequence = ("VALID",),
        activation: str | Callable = "relu",
        layer_norm: bool = False,
        norm_eps: float = 1e-5,
    ):
        super().__init__()
        n = len(channels)
        kernels, strides, paddings = (list(v) * n if len(v) == 1 else list(v) for v in (kernels, strides, paddings))
        if any(isinstance(p, str) and p.upper() != "VALID" for p in paddings):
            raise NotImplementedError(f"CNN paddings {paddings}: only VALID or explicit ints are ported")
        chans = [in_channels, *channels]
        self.convs = nn.ModuleList(
            Conv2d(a, b, k, stride=s, padding=0 if isinstance(p, str) else int(p))
            for a, b, k, s, p in zip(chans[:-1], chans[1:], kernels, strides, paddings)
        )
        self.norms = nn.ModuleList(LayerNorm(c, norm_eps) for c in channels) if layer_norm else None
        self.act = _activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if self.norms is not None:
                x = self.norms[i](x.movedim(1, -1)).movedim(-1, 1)
            if self.act is not None:
                x = self.act(x)
        return x


class MultiEncoder(nn.Module):
    """Fuse dict observations into one feature vector (reference ``blocks.py:221``).

    ``cnn_shapes`` maps each image key to its observation shape, ``[C, H, W]`` or
    ``[S, C, H, W]`` (frame-stacked); the keys are concatenated channel-wise into one
    ``CNN`` (VALID padding), whose last map is flattened in the reference's ``H, W, C``
    order, so that the 512-wide ``dense.0`` takes its rows as Flax's ``Dense_0`` does and a
    carried kernel needs only its transpose. ``mlp_dims`` maps each vector key to its
    width; they are concatenated into one ``MLP``. The outputs are concatenated, images
    first. Children follow the reference's names: ``cnn`` (``CNN_0``), ``dense``
    (``Dense_0``), ``mlp`` (``MLP_0``)."""

    def __init__(
        self,
        cnn_shapes: Dict[str, Sequence[int]],
        mlp_dims: Dict[str, int],
        cnn_channels: Sequence[int] = (32, 64, 64),
        cnn_kernels: Sequence[int] = (8, 4, 3),
        cnn_strides: Sequence[int] = (4, 2, 1),
        cnn_features_dim: int = 512,
        mlp_hidden_sizes: Sequence[int] = (256, 256),
        mlp_features_dim: Optional[int] = None,
        activation: str | Callable = "relu",
        layer_norm: bool = False,
    ):
        super().__init__()
        self.cnn_keys, self.mlp_keys = list(cnn_shapes), list(mlp_dims)
        self.stacked = {k: len(s) == 4 for k, s in cnn_shapes.items()}
        self.act = _activation(activation)
        self.output_dim = 0
        if self.cnn_keys:
            shapes = list(cnn_shapes.values())
            in_channels = sum(int(math.prod(s[:-2])) for s in shapes)
            self.cnn = CNN(in_channels, cnn_channels, cnn_kernels, cnn_strides, ("VALID",), activation, layer_norm)
            with torch.no_grad():
                side = self.cnn(torch.zeros(1, in_channels, *shapes[0][-2:]))
            self.dense = nn.ModuleList([Linear(side.numel(), cnn_features_dim)])
            self.output_dim += cnn_features_dim
        if self.mlp_keys:
            self.mlp = MLP(sum(mlp_dims.values()), mlp_hidden_sizes, mlp_features_dim, activation, layer_norm)
            self.output_dim += self.mlp.output_dim

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.cnn_keys:
            imgs = torch.cat([cnn_obs_to_nchw(obs[k], self.stacked[k]) for k in self.cnn_keys], -3)
            lead = imgs.shape[:-3]
            x = self.cnn(imgs.reshape(-1, *imgs.shape[-3:]))
            x = self.dense[0](x.permute(0, 2, 3, 1).reshape(*lead, -1))
            feats.append(self.act(x) if self.act is not None else x)
        if self.mlp_keys:
            dt = self.mlp.dense[0].compute_dtype
            feats.append(self.mlp(torch.cat([obs[k].to(dt) for k in self.mlp_keys], -1)))
        return torch.cat(feats, -1)
