"""DreamerV1 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v1/utils.py``): the
aggregated metric names, DreamerV1's lambda-targets, and the host-side helpers it shares
with DreamerV3 (``prepare_obs``, ``test``)."""

from __future__ import annotations

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs, test

__all__ = ["AGGREGATOR_KEYS", "compute_lambda_values", "prepare_obs", "test"]

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
    "State/prior_entropy",
    "Params/exploration_amount",
}


def compute_lambda_values(
    rewards: torch.Tensor,  # [H, N, 1] rewards at the imagined states
    values: torch.Tensor,  # [H, N, 1]
    continues: torch.Tensor,  # [H, N, 1], already scaled by gamma
    lmbda: float = 0.95,
) -> torch.Tensor:
    """DreamerV1's ``H - 1`` targets: ``l[i] = r[i] + c[i] * (1 - lambda) * V[i + 1] +
    lambda * c[i] * l[i + 1]`` for ``i < H - 2``, and the last bootstraps the whole
    value, ``l[H - 2] = r[H - 2] + c[H - 2] * V[H - 1]``; a reverse loop over the
    horizon. Returns ``[H - 1, N, 1]``."""
    horizon = rewards.shape[0]
    next_values = torch.cat([values[1 : horizon - 1] * (1 - lmbda), values[horizon - 1 : horizon]], 0)
    inputs = rewards[: horizon - 1] + continues[: horizon - 1] * next_values
    agg, out = torch.zeros_like(values[0]), [None] * (horizon - 1)
    for i in reversed(range(horizon - 1)):
        agg = inputs[i] + continues[i] * lmbda * agg
        out[i] = agg
    return torch.stack(out)
