"""Algorithm registry population (counterpart of ``sheeprl_tpu/algos/__init__.py``).
Ported so far: DreamerV3, DreamerV2, DreamerV1, P2E on each of them (exploration and
finetuning), PPO, A2C and recurrent PPO, SAC, DroQ and SAC-AE, the thread-decoupled
``ppo_decoupled`` and ``sac_decoupled``, their train and evaluation entries."""

from sheeprl_tpu_torch.algos.a2c import a2c as _a2c  # noqa: F401
from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as _dv1  # noqa: F401
from sheeprl_tpu_torch.algos.dreamer_v1 import evaluate as _dv1_eval  # noqa: F401
from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as _dv2  # noqa: F401
from sheeprl_tpu_torch.algos.dreamer_v2 import evaluate as _dv2_eval  # noqa: F401
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as _dv3  # noqa: F401
from sheeprl_tpu_torch.algos.dreamer_v3 import evaluate as _dv3_eval  # noqa: F401
from sheeprl_tpu_torch.algos.droq import droq as _droq  # noqa: F401
from sheeprl_tpu_torch.algos.droq import evaluate as _droq_eval  # noqa: F401
from sheeprl_tpu_torch.algos.p2e_dv1 import evaluate as _p2e_dv1_eval  # noqa: F401
from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_exploration as _p2e_dv1_expl  # noqa: F401
from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_finetuning as _p2e_dv1_fine  # noqa: F401
from sheeprl_tpu_torch.algos.p2e_dv2 import evaluate as _p2e_dv2_eval  # noqa: F401
from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_exploration as _p2e_dv2_expl  # noqa: F401
from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_finetuning as _p2e_dv2_fine  # noqa: F401
from sheeprl_tpu_torch.algos.p2e_dv3 import evaluate as _p2e_dv3_eval  # noqa: F401
from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as _p2e_dv3_expl  # noqa: F401
from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_finetuning as _p2e_dv3_fine  # noqa: F401
from sheeprl_tpu_torch.algos.ppo import evaluate as _ppo_eval  # noqa: F401
from sheeprl_tpu_torch.algos.ppo import ppo as _ppo  # noqa: F401
from sheeprl_tpu_torch.algos.ppo import ppo_decoupled as _ppo_decoupled  # noqa: F401
from sheeprl_tpu_torch.algos.ppo_recurrent import evaluate as _ppo_rec_eval  # noqa: F401
from sheeprl_tpu_torch.algos.ppo_recurrent import ppo_recurrent as _ppo_rec  # noqa: F401
from sheeprl_tpu_torch.algos.sac import evaluate as _sac_eval  # noqa: F401
from sheeprl_tpu_torch.algos.sac import sac as _sac  # noqa: F401
from sheeprl_tpu_torch.algos.sac import sac_decoupled as _sac_decoupled  # noqa: F401
from sheeprl_tpu_torch.algos.sac_ae import evaluate as _sac_ae_eval  # noqa: F401
from sheeprl_tpu_torch.algos.sac_ae import sac_ae as _sac_ae  # noqa: F401
