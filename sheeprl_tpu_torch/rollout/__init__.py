"""The acting pipeline (counterpart of ``sheeprl_tpu/rollout``): ``PipelinedPlayer``
and ``rollout_metrics``. The reference's shared-memory env pool (``env.pool``), its
workers and its sharding are not ported."""

from sheeprl_tpu_torch.rollout.pipeline import PipelinedPlayer  # noqa: F401
from sheeprl_tpu_torch.rollout.pool import rollout_metrics  # noqa: F401
