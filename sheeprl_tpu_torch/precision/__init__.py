from sheeprl_tpu_torch.precision.policy import train_policy  # noqa: F401
