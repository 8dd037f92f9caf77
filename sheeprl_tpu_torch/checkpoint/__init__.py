"""Crash-safe checkpoints for the port (counterpart of ``sheeprl_tpu/checkpoint``)."""
from sheeprl_tpu_torch.checkpoint.manager import CheckpointCorruptError, CheckpointManager

__all__ = ["CheckpointCorruptError", "CheckpointManager"]
