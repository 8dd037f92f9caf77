"""Loss scaling for float16 training (counterpart of ``sheeprl_tpu/precision/loss_scale.py``).

A library, as in the reference: no train loop uses it (bfloat16 shares float32's
exponent range and needs none; float16 training is refused). The scale and counter are
tensors, so a scale can live on the device beside the parameters. Usage::

    loss = scale.scale(loss_fn(params))
    grads = scale.unscale(torch.autograd.grad(loss, params))
    finite = all_finite(grads)
    scale = scale.adjust(finite)        # and skip the update where not finite
"""

from __future__ import annotations

from typing import Any

import torch

from sheeprl_tpu_torch.precision.policy import _map
from sheeprl_tpu_torch.utils.graphs import tree_tensors


def all_finite(tree: Any) -> torch.Tensor:
    """A 0-d boolean tensor: True iff every floating-point tensor of ``tree`` is finite."""
    leaves = [x for x in tree_tensors(tree) if torch.is_floating_point(x)]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(x).all() for x in leaves]).all()


def _unscale(tree: Any, loss_scale: torch.Tensor) -> Any:
    inv = (1.0 / loss_scale).to(torch.float32)
    return _map(tree, lambda g: (g.to(torch.float32) * inv.to(g.device)).to(g.dtype))


class NoOpLossScale:
    """Identity scaling: the policy for float32 and bfloat16 training."""

    def scale(self, loss: torch.Tensor) -> torch.Tensor:
        return loss

    def unscale(self, tree: Any) -> Any:
        return tree

    def adjust(self, grads_finite: torch.Tensor) -> "NoOpLossScale":
        return self


class StaticLossScale:
    """A fixed multiplicative loss scale."""

    def __init__(self, scale: Any):
        self.loss_scale = torch.as_tensor(scale, dtype=torch.float32)

    def scale(self, loss: torch.Tensor) -> torch.Tensor:
        return loss * self.loss_scale.to(loss.dtype)

    def unscale(self, tree: Any) -> Any:
        return _unscale(tree, self.loss_scale)

    def adjust(self, grads_finite: torch.Tensor) -> "StaticLossScale":
        return self


class DynamicLossScale:
    """A doubling/halving loss scale (jmp's semantics): after ``period`` finite steps in a
    row the scale grows by ``factor``; on non-finite gradients it shrinks by
    ``factor`` (not below ``min_scale``) and the counter restarts. The caller skips the
    update when the gradients are not finite."""

    def __init__(self, scale: Any = 2.0**15, counter: Any = 0, period: int = 2000, factor: int = 2, min_scale: float = 1.0):
        self.loss_scale = torch.as_tensor(scale, dtype=torch.float32)
        self.counter = torch.as_tensor(counter, dtype=torch.int32)
        self.period = int(period)
        self.factor = int(factor)
        self.min_scale = float(min_scale)

    def scale(self, loss: torch.Tensor) -> torch.Tensor:
        return loss * self.loss_scale.to(loss.dtype)

    def unscale(self, tree: Any) -> Any:
        return _unscale(tree, self.loss_scale)

    def adjust(self, grads_finite: torch.Tensor) -> "DynamicLossScale":
        finite = torch.as_tensor(grads_finite, dtype=torch.bool, device=self.loss_scale.device)
        grow = self.counter == (self.period - 1)
        new_scale = torch.where(
            finite,
            torch.where(grow, self.loss_scale * self.factor, self.loss_scale),
            torch.clamp_min(self.loss_scale / self.factor, self.min_scale),
        )
        zero = torch.zeros_like(self.counter)
        new_counter = torch.where(finite, torch.where(grow, zero, self.counter + 1), zero).to(torch.int32)
        return DynamicLossScale(new_scale, new_counter, self.period, self.factor, self.min_scale)
