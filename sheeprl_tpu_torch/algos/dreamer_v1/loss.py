"""DreamerV1 world-model loss (counterpart of ``sheeprl_tpu/algos/dreamer_v1/loss.py``).

The ELBO with a Gaussian KL: ``KL(posterior || prior)`` summed over the state, its batch
mean clipped below at ``kl_free_nats`` (``max(kl, free_nats)``, whose gradient is zero
while the KL lies below), with no KL balancing. The continue term is the negative
log-likelihood of the continues, as in the JAX package (the reference reads it with the
opposite sign).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["normal_kl", "reconstruction_loss"]


def normal_kl(post_mean, post_std, prior_mean, prior_std) -> torch.Tensor:
    """KL( N(post) || N(prior) ) summed over the last axis."""
    var_ratio = (post_std / prior_std) ** 2
    t1 = ((post_mean - prior_mean) / prior_std) ** 2
    return 0.5 * torch.sum(var_ratio + t1 - 1.0 - torch.log(var_ratio), -1)


def reconstruction_loss(
    observation_lp: torch.Tensor,  # [T, B] summed over the decoded keys
    reward_lp: torch.Tensor,  # [T, B]
    posterior_mean_std: Tuple[torch.Tensor, torch.Tensor],
    prior_mean_std: Tuple[torch.Tensor, torch.Tensor],
    kl_free_nats: float = 3.0,
    kl_regularizer: float = 1.0,
    continue_lp: Optional[torch.Tensor] = None,  # [T, B]
    continue_scale_factor: float = 10.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    observation_loss = -observation_lp.mean()
    reward_loss = -reward_lp.mean()
    kl = normal_kl(*posterior_mean_std, *prior_mean_std).mean()
    state_loss = torch.clamp_min(kl, kl_free_nats)
    if continue_lp is not None:
        continue_loss = continue_scale_factor * -continue_lp.mean()
    else:
        continue_loss = torch.zeros_like(reward_loss)
    total = kl_regularizer * state_loss + observation_loss + reward_loss + continue_loss
    metrics = {
        "Loss/world_model_loss": total.detach(),
        "Loss/observation_loss": observation_loss.detach(),
        "Loss/reward_loss": reward_loss.detach(),
        "Loss/state_loss": state_loss.detach(),
        "Loss/continue_loss": continue_loss.detach(),
        "State/kl": kl.detach(),
    }
    return total, metrics
