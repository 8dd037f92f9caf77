"""DreamerV2 world-model loss (counterpart of ``sheeprl_tpu/algos/dreamer_v2/loss.py``).

KL balancing: the KL between the posterior and prior categoricals is taken twice, once
with the posterior stopped (training the prior, weight ``kl_balancing_alpha``) and once
with the prior stopped (regularising the posterior, weight ``1 - alpha``), each clipped
below at ``kl_free_nats``: on the batch mean with ``kl_free_avg`` (the default), else per
element before the mean."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.loss import categorical_kl

__all__ = ["categorical_kl", "reconstruction_loss"]


def reconstruction_loss(
    observation_lp: torch.Tensor,  # [T, B] summed over the decoded keys
    reward_lp: torch.Tensor,  # [T, B]
    prior_logits: torch.Tensor,  # [T, B, stoch, discrete]
    posterior_logits: torch.Tensor,  # [T, B, stoch, discrete]
    kl_balancing_alpha: float = 0.8,
    kl_free_nats: float = 0.0,
    kl_free_avg: bool = True,
    kl_regularizer: float = 1.0,
    continue_lp: Optional[torch.Tensor] = None,  # [T, B]
    discount_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    observation_loss = -observation_lp.mean()
    reward_loss = -reward_lp.mean()
    lhs = categorical_kl(posterior_logits.detach(), prior_logits)
    rhs = categorical_kl(posterior_logits, prior_logits.detach())
    if kl_free_avg:
        loss_lhs = lhs.mean().clamp_min(kl_free_nats)
        loss_rhs = rhs.mean().clamp_min(kl_free_nats)
    else:
        loss_lhs = lhs.clamp_min(kl_free_nats).mean()
        loss_rhs = rhs.clamp_min(kl_free_nats).mean()
    kl_loss = kl_balancing_alpha * loss_lhs + (1 - kl_balancing_alpha) * loss_rhs
    if continue_lp is not None:
        continue_loss = discount_scale_factor * -continue_lp.mean()
    else:
        continue_loss = torch.zeros_like(reward_loss)
    total = kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss
    metrics = {
        "Loss/world_model_loss": total.detach(),
        "Loss/observation_loss": observation_loss.detach(),
        "Loss/reward_loss": reward_loss.detach(),
        "Loss/state_loss": kl_loss.detach(),
        "Loss/continue_loss": continue_loss.detach(),
        "State/kl": lhs.mean().detach(),
    }
    return total, metrics
