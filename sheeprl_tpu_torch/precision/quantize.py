"""Int8 weight-only quantization for serving (counterpart of
``sheeprl_tpu/precision/quantize.py``).

Each quantized weight becomes an :class:`Int8Weight`: ``q`` int8 and a per-output-channel
float32 ``scale``, ``scale = max(|w|) / 127`` over the input axis (at least 1e-8) and
``q = clip(round(w / scale), -127, 127)``; ``torch.round`` rounds half to even as
``jnp.round`` does, so ``q`` is the reference's bit for bit. The layouts differ: a Flax
kernel is ``[in, out]`` and reduces over axis 0, ``nn.Linear.weight`` is ``[out, in]``
and reduces over dim 1, so ``scale`` is ``[out, 1]`` here where it is ``[1, out]``
there. The act function dequantizes (``q.float() * scale``) on every call, inside the
bucket's CUDA graph: the device holds int8 weights, a quarter of the float32 bytes.

Which leaves: the reference quantizes every 2-D float leaf of its tree, that is the
Dense kernels, never a 4-D conv kernel, a 1-D bias or a LayerNorm scale. The port
quantizes exactly the parameters whose reference leaf is 2-D, read from the reference's
layout (``algos/dreamer_v3/params.py::reference_ndim``), not from the tensor's rank.
"""

from __future__ import annotations

from typing import Any, Collection, Dict

import torch

# Smallest scale: no division by zero on an all-zero channel.
_MIN_SCALE = 1e-8


class Int8Weight:
    """An int8 weight ``[out, in]`` and its per-output-channel float32 scale ``[out, 1]``."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.q.to(dtype) * self.scale.to(dtype)

    def __repr__(self) -> str:
        return f"Int8Weight(shape={tuple(self.q.shape)})"


def quantize_weight(w: torch.Tensor) -> Int8Weight:
    """Quantize one ``[out, in]`` float weight with per-output-channel scales."""
    w32 = w.detach().float()
    scale = torch.clamp_min(w32.abs().amax(dim=1, keepdim=True) / 127.0, _MIN_SCALE)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return Int8Weight(q=q, scale=scale)


def quantize_params(params: Dict[str, torch.Tensor], kernels: Collection[str]) -> Dict[str, Any]:
    """``params`` with every float entry named in ``kernels`` (the keys whose reference
    leaf is a 2-D Dense kernel) replaced by an :class:`Int8Weight`."""
    return {
        k: quantize_weight(v) if k in kernels and torch.is_floating_point(v) else v
        for k, v in params.items()
    }


def dequantize_params(params: Dict[str, Any], dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """:class:`Int8Weight` entries expanded back to float; every other entry as it is."""
    return {k: v.dequantize(dtype) if isinstance(v, Int8Weight) else v for k, v in params.items()}
