"""Core math utilities (counterpart of ``sheeprl_tpu/utils/utils.py``).

Ported so far: ``symlog``/``symexp``. The returns, two-hot and replay-ratio helpers
come with the training slice.
"""

from __future__ import annotations

import torch


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1)
