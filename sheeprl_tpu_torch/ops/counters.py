"""The launch counters of the port's kernels, by kernel name.

Each wrapper adds one to its own ``launches`` where it launches its kernel and nowhere
else; a caller zeroes them all before a path and reads them all after it. A step
captured in a CUDA graph (``utils/graphs.py``) launches its kernels on every replay, not
in its wrappers: the capture takes back what the wrappers counted while it recorded
them, and each replay adds those counts (``add_launches``).
"""

from __future__ import annotations

from sheeprl_tpu_torch.ops.gru import layernorm_gru, layernorm_gru_backward
from sheeprl_tpu_torch.ops.rssm_step import gru_step, gru_step_backward

COUNTED = {
    "rssm_step": gru_step,
    "rssm_step_bwd": gru_step_backward,
    "layernorm_gru": layernorm_gru,
    "layernorm_gru_bwd": layernorm_gru_backward,
}


def zero_launches() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def set_launches(counts: dict) -> None:
    for name, n in counts.items():
        COUNTED[name].launches = n


def add_launches(counts: dict) -> None:
    for name, n in counts.items():
        COUNTED[name].launches += n
