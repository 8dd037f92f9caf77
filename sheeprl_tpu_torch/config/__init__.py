"""Configuration composition for the port (counterpart of ``sheeprl_tpu/config``)."""
