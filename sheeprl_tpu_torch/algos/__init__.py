"""Algorithm registry population (counterpart of ``sheeprl_tpu/algos/__init__.py``).
Ported so far: DreamerV3 and DreamerV2, their train and evaluation entries."""

from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as _dv2  # noqa: F401
from sheeprl_tpu_torch.algos.dreamer_v2 import evaluate as _dv2_eval  # noqa: F401
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as _dv3  # noqa: F401
from sheeprl_tpu_torch.algos.dreamer_v3 import evaluate as _dv3_eval  # noqa: F401
