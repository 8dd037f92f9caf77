"""Environments (counterpart of ``sheeprl_tpu/envs``): the dummy envs and the generic wrappers."""
