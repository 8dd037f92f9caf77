"""SAC losses (counterpart of ``sheeprl_tpu/algos/sac/loss.py``)."""

from __future__ import annotations

import torch


def critic_loss(qs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The critics' mean squared errors against the shared target, summed over the
    critics; ``qs``: ``[n, B, 1]``."""
    return ((qs - target[None]) ** 2).mean(dim=(1, 2)).sum()


def actor_loss(alpha: torch.Tensor, logp: torch.Tensor, min_q: torch.Tensor) -> torch.Tensor:
    return (alpha * logp - min_q).mean()


def alpha_loss(log_alpha: torch.Tensor, logp: torch.Tensor, target_entropy: float) -> torch.Tensor:
    """The temperature's loss; no gradient flows into the log-probs."""
    return -(torch.exp(log_alpha) * (logp.detach() + target_entropy)).mean()
