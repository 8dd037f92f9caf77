"""DreamerV3 world-model loss (counterpart of ``sheeprl_tpu/algos/dreamer_v3/loss.py``).

The two-sided KL balancing with free nats keeps the reference's stop-gradient placement:
``dyn_loss = KL(sg(post) || prior)``, ``repr_loss = KL(post || sg(prior))``."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def categorical_kl(post_logits: torch.Tensor, prior_logits: torch.Tensor) -> torch.Tensor:
    """KL over the last (discrete) axis, summed over the stochastic axis: inputs
    ``[..., stoch, discrete]`` raw logits, output ``[...]``."""
    post_logp = torch.log_softmax(post_logits, -1)
    prior_logp = torch.log_softmax(prior_logits, -1)
    return (post_logp.exp() * (post_logp - prior_logp)).sum(-1).sum(-1)


def reconstruction_loss(
    observation_log_probs: torch.Tensor,  # [T, B] summed over obs keys
    reward_log_prob: torch.Tensor,  # [T, B]
    priors_logits: torch.Tensor,  # [T, B, stoch, discrete]
    posteriors_logits: torch.Tensor,  # [T, B, stoch, discrete]
    kl_dynamic: float = 0.5,
    kl_representation: float = 0.1,
    kl_free_nats: float = 1.0,
    kl_regularizer: float = 1.0,
    continue_log_prob: Optional[torch.Tensor] = None,  # [T, B]
    continue_scale_factor: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    observation_loss = -observation_log_probs
    reward_loss = -reward_log_prob
    kl = categorical_kl(posteriors_logits.detach(), priors_logits)
    dyn_loss = kl_dynamic * kl.clamp_min(kl_free_nats)
    repr_kl = categorical_kl(posteriors_logits, priors_logits.detach())
    repr_loss = kl_representation * repr_kl.clamp_min(kl_free_nats)
    kl_loss = dyn_loss + repr_loss
    if continue_log_prob is not None:
        continue_loss = continue_scale_factor * -continue_log_prob
    else:
        continue_loss = torch.zeros_like(reward_loss)
    rec_loss = (kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss).mean()
    metrics = {
        "Loss/world_model_loss": rec_loss.detach(),
        "Loss/observation_loss": observation_loss.mean().detach(),
        "Loss/reward_loss": reward_loss.mean().detach(),
        "Loss/state_loss": kl_loss.mean().detach(),
        "Loss/continue_loss": continue_loss.mean().detach(),
        "State/kl": kl.mean().detach(),
    }
    return rec_loss, metrics
