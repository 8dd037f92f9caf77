"""P2E-DV1 helpers (counterpart of ``sheeprl_tpu/algos/p2e_dv1/utils.py``): the aggregated
metric names."""

from __future__ import annotations

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "Loss/ensemble_loss",
    "Loss/policy_loss_task",
    "Loss/value_loss_task",
    "Loss/policy_loss_exploration",
    "Loss/value_loss_exploration",
    "State/kl",
    "State/post_entropy",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
    "State/prior_entropy",
    "Params/exploration_amount",
    "Rewards/intrinsic",
    "Values_exploration/predicted_values",
    "Values_exploration/lambda_values",
}
