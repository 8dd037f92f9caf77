"""PPO losses (counterpart of ``sheeprl_tpu/algos/ppo/loss.py``)."""

from __future__ import annotations

import torch


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    return x.mean() if reduction == "mean" else x.sum()


def policy_loss(new_logprobs: torch.Tensor, old_logprobs: torch.Tensor, advantages: torch.Tensor, clip_coef, reduction: str = "mean") -> torch.Tensor:
    """The clipped surrogate objective, negated."""
    ratio = torch.exp(new_logprobs - old_logprobs)
    surr1 = advantages * ratio
    surr2 = advantages * torch.clamp(ratio, 1.0 - clip_coef, 1.0 + clip_coef)
    return -_reduce(torch.minimum(surr1, surr2), reduction)


def value_loss(new_values: torch.Tensor, old_values: torch.Tensor, returns: torch.Tensor, clip_coef, clip_vloss: bool, reduction: str = "mean") -> torch.Tensor:
    """Squared error to the returns; with ``clip_vloss``, half the larger of it and the
    error of the values clipped to ``old +- clip_coef``."""
    if not clip_vloss:
        return _reduce((new_values - returns) ** 2, reduction)
    clipped = old_values + torch.clamp(new_values - old_values, -clip_coef, clip_coef)
    err = torch.maximum((new_values - returns) ** 2, (clipped - returns) ** 2)
    return 0.5 * _reduce(err, reduction)


def entropy_loss(entropy: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return -_reduce(entropy, reduction)
