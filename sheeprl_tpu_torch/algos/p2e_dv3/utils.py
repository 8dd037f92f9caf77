"""P2E-DV3 helpers (counterpart of ``sheeprl_tpu/algos/p2e_dv3/utils.py``): the aggregated
metric names and the modules a run registers."""

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
    "State/kl",
    "State/post_entropy",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
    "State/prior_entropy",
}
MODELS_TO_REGISTER = {
    "world_model",
    "ensembles",
    "actor_exploration",
    "actor_task",
    "critic_task",
    "target_critic_task",
    "moments_task",
    "moments_exploration",
}
