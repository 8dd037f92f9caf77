"""Core math utilities (counterpart of ``sheeprl_tpu/utils/utils.py``).

Ported: ``symlog``/``symexp``, the two-hot encoder and decoder of the DreamerV3 reward
and value heads, the replay-ratio governor ``Ratio``, the DreamerV1/V2 players'
exploration schedule ``exploration_amount``, and the PPO family's ``gae``,
``polynomial_decay`` and ``normalize_tensor``.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1)


def two_hot_encoder(x: torch.Tensor, support_range: int = 300, num_buckets: Optional[int] = None) -> torch.Tensor:
    """Two-hot encode scalars ``[..., 1] -> [..., num_buckets]`` over the linear support
    ``[-support_range, support_range]`` (odd bucket count), each of the two neighbouring
    buckets weighted by its distance to ``x``."""
    if num_buckets is None:
        num_buckets = support_range * 2 + 1
    if num_buckets % 2 == 0:
        raise ValueError("num_buckets must be odd")
    x = x.clamp(-support_range, support_range)
    buckets = torch.linspace(-support_range, support_range, num_buckets, dtype=x.dtype, device=x.device)
    bucket_size = (2.0 * support_range) / (num_buckets - 1) if num_buckets > 1 else 1.0
    # right: the first bucket >= x (searchsorted side="left"), as the reference
    right = torch.searchsorted(buckets, x.contiguous(), side="left").clamp(0, num_buckets - 1)
    left = (right - 1).clamp(0, num_buckets - 1)
    left_w = (buckets[right] - x).abs() / bucket_size
    right_w = 1.0 - left_w
    oh_left = F.one_hot(left[..., 0], num_buckets).to(x.dtype) * left_w
    oh_right = F.one_hot(right[..., 0], num_buckets).to(x.dtype) * right_w
    return oh_left + oh_right


def two_hot_decoder(t: torch.Tensor, support_range: int) -> torch.Tensor:
    num_buckets = t.shape[-1]
    if num_buckets % 2 == 0:
        raise ValueError("support size must be odd")
    support = torch.linspace(-support_range, support_range, num_buckets, dtype=t.dtype, device=t.device)
    return (t * support).sum(-1, keepdim=True)


def gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    next_value: torch.Tensor,
    num_steps: int,
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE over a ``[T, n_envs, 1]`` rollout, the reference's reverse ``lax.scan`` as a
    loop over ``num_steps``. ``dones[t]`` marks that the episode ended at step ``t``, so
    step ``t``'s bootstrap is masked. Returns ``(returns, advantages)``, shaped as
    ``rewards``."""
    not_done = 1.0 - dones.to(values.dtype)
    next_values = torch.cat([values[1:], next_value[None]], 0)
    adv = torch.zeros_like(next_value)
    advs = [None] * num_steps
    for t in reversed(range(num_steps)):
        delta = rewards[t] + gamma * next_values[t] * not_done[t] - values[t]
        adv = delta + gamma * gae_lambda * not_done[t] * adv
        advs[t] = adv
    advantages = torch.stack(advs)
    return advantages + values, advantages


def polynomial_decay(current_step: int, *, initial: float = 1.0, final: float = 0.0, max_decay_steps: int = 100, power: float = 1.0) -> float:
    if current_step > max_decay_steps or initial == final:
        return final
    return (initial - final) * ((1 - current_step / max_decay_steps) ** power) + final


def normalize_tensor(x: torch.Tensor, eps: float = 1e-8, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(x - mean) / (std + eps)``: over all of ``x`` with the population std (ddof 0,
    as ``jnp.std``; ``torch.std``'s default is ddof 1), or over the entries where
    ``mask`` is set with the sample std (divided by ``n - 1``, at least 1)."""
    if mask is None:
        return (x - x.mean()) / (x.std(correction=0) + eps)
    m = mask.to(x.dtype)
    n = m.sum()
    mean = (x * m).sum() / n
    var = (((x - mean) ** 2) * m).sum() / torch.clamp(n - 1, min=1)
    return (x - mean) / (torch.sqrt(var) + eps)


def exploration_amount(expl_amount: float, expl_decay: float, expl_min: float, step: int) -> float:
    """The exploration schedule: ``max(amount * 0.5 ** (step / decay), min)`` (Hafner's,
    as the JAX package reads the reference's)."""
    amount = expl_amount
    if expl_decay:
        amount *= 0.5 ** (float(step) / expl_decay)
    return max(amount, expl_min)


class Ratio:
    """Replay-ratio governor (Hafner). Called with the cumulative policy-step count, it
    returns how many gradient steps to run this iteration so that the long-run ratio of
    gradient steps to policy steps converges to ``ratio``."""

    def __init__(self, ratio: float, pretrain_steps: int = 0):
        if pretrain_steps < 0:
            raise ValueError(f"'pretrain_steps' must be non-negative, got {pretrain_steps}")
        if ratio < 0:
            raise ValueError(f"'ratio' must be non-negative, got {ratio}")
        self._pretrain_steps = pretrain_steps
        self._ratio = ratio
        self._prev: Optional[float] = None

    def __call__(self, step: int) -> int:
        if self._ratio == 0:
            return 0
        if self._prev is None:
            self._prev = step
            repeats = int(step * self._ratio)
            if self._pretrain_steps > 0:
                if step < self._pretrain_steps:
                    warnings.warn(
                        "pretrain_steps > current steps; clamping pretrain_steps to the "
                        "current step count to keep the requested replay ratio."
                    )
                    self._pretrain_steps = step
                repeats = int(self._pretrain_steps * self._ratio)
            return repeats
        repeats = int((step - self._prev) * self._ratio)
        self._prev += repeats / self._ratio
        return repeats

    def state_dict(self) -> Dict[str, Any]:
        return {"_ratio": self._ratio, "_prev": self._prev, "_pretrain_steps": self._pretrain_steps}

    def load_state_dict(self, state: Mapping[str, Any]) -> "Ratio":
        self._ratio = state["_ratio"]
        self._prev = state["_prev"]
        self._pretrain_steps = state["_pretrain_steps"]
        return self
