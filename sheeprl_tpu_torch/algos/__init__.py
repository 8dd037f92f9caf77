"""Algorithm registry population (counterpart of ``sheeprl_tpu/algos/__init__.py``).
Ported so far: DreamerV3, its train and evaluation entries."""

from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as _dv3  # noqa: F401
from sheeprl_tpu_torch.algos.dreamer_v3 import evaluate as _dv3_eval  # noqa: F401
