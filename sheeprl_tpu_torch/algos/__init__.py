"""Algorithm registry population (counterpart of ``sheeprl_tpu/algos/__init__.py``).
Ported so far: the DreamerV3 evaluation entry."""

from sheeprl_tpu_torch.algos.dreamer_v3 import evaluate as _dv3_eval  # noqa: F401
