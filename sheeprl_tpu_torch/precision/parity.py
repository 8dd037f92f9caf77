"""Parity metrics between two policies at different precisions (counterpart of
``sheeprl_tpu/precision/parity.py``): the serve startup's parity stamp compares a bf16
or int8 policy with its float32 reference by them. Inputs are tensors (on any device)
or numpy arrays; results are Python floats or numpy masks."""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.dtype == torch.bfloat16 else x.detach().cpu().numpy()
    return np.asarray(x)


def _f32(x: Any) -> torch.Tensor:
    return x.detach().float().cpu() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), dtype=torch.float32)


def action_agreement(actions_a: Any, actions_b: Any, continuous: bool = False, atol: float = 1e-2) -> float:
    """Fraction of rows on which two policies pick the same greedy action: discrete
    actions equal, continuous ones within ``atol`` in every component. Inputs are
    ``[batch, ...]`` (or lists of them, compared per component and ANDed)."""
    if isinstance(actions_a, (list, tuple)):
        per = [action_agreement_mask(a, b, continuous=continuous, atol=atol) for a, b in zip(actions_a, actions_b)]
        return float(np.logical_and.reduce(per).mean())
    return float(action_agreement_mask(actions_a, actions_b, continuous=continuous, atol=atol).mean())


def action_agreement_mask(actions_a: Any, actions_b: Any, continuous: bool = False, atol: float = 1e-2) -> np.ndarray:
    """Boolean per-row agreement mask (see :func:`action_agreement`)."""
    a, b = _host(actions_a), _host(actions_b)
    if continuous:
        close = np.abs(a.astype(np.float64) - b.astype(np.float64)) <= atol
        return close.reshape(close.shape[0], -1).all(axis=-1)
    return (a.reshape(a.shape[0], -1) == b.reshape(b.shape[0], -1)).all(axis=-1)


def categorical_kl(logits_p: Any, logits_q: Any) -> float:
    """Mean KL(p || q) between two batches of categorical logits, in nats."""
    logp = F.log_softmax(_f32(logits_p), dim=-1)
    logq = F.log_softmax(_f32(logits_q), dim=-1)
    return float(torch.sum(torch.exp(logp) * (logp - logq), dim=-1).mean())


def gaussian_mean_divergence(mean_p: Any, mean_q: Any, log_std_p: Optional[Any] = None) -> float:
    """Mean absolute divergence of continuous policy means, over the reference's std
    when given (a stand-in for the KL of tanh-squashed policies, which has no closed
    form)."""
    d = torch.abs(_f32(mean_p) - _f32(mean_q))
    if log_std_p is not None:
        d = d / torch.clamp_min(torch.exp(_f32(log_std_p)), 1e-6)
    return float(d.mean())
