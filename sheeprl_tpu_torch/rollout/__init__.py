"""The acting pipeline (counterpart of ``sheeprl_tpu/rollout``): ``PipelinedPlayer``
and ``rollout_metrics``, and the sharding of an env-pool budget across Sebulba actors
(``sharding.py``). The reference's shared-memory env pool (``env.pool``) and its workers
are not ported."""

from sheeprl_tpu_torch.rollout.pipeline import PipelinedPlayer  # noqa: F401
from sheeprl_tpu_torch.rollout.pool import rollout_metrics  # noqa: F401
