"""DreamerV2 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v2/utils.py``): the
aggregated metric names, the lambda-returns, and the host-side helpers it shares with
DreamerV3 (``prepare_obs``, ``test``)."""

from __future__ import annotations

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.utils import AGGREGATOR_KEYS, prepare_obs, test

__all__ = ["AGGREGATOR_KEYS", "compute_lambda_values", "prepare_obs", "test"]


def compute_lambda_values(
    rewards: torch.Tensor,  # [H, N, 1]
    values: torch.Tensor,  # [H, N, 1]
    continues: torch.Tensor,  # [H, N, 1], already scaled by gamma
    bootstrap: torch.Tensor,  # [1, N, 1]
    lmbda: float = 0.95,
) -> torch.Tensor:
    """TD(lambda) targets over an imagined trajectory: ``l[i] = r[i] + c[i] * ((1 -
    lambda) * V[i + 1] + lambda * l[i + 1])`` with ``l[H] = bootstrap``, as a reverse loop
    over the horizon. Returns ``[H, N, 1]``."""
    next_values = torch.cat([values[1:], bootstrap], 0)
    inputs = rewards + continues * next_values * (1 - lmbda)
    agg, out = bootstrap[0], [None] * rewards.shape[0]
    for i in reversed(range(rewards.shape[0])):
        agg = inputs[i] + continues[i] * lmbda * agg
        out[i] = agg
    return torch.stack(out)
