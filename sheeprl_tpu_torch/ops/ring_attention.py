"""Attention for the recurrent PPO's ``attention`` sequence model (counterpart of
``sheeprl_tpu/ops/ring_attention.py``): ``reference_attention``, the plain
full-materialisation attention that is the single-device path, and its masks
``_block_mask``. Plain tensor code; no kernel of the reference's sits here. The ring
itself (sequence parallelism over ``mesh.sequence > 1``) is not ported: the loops refuse
that key.

Shapes: ``q, k, v: [B, T, H, D]``; ``segment_ids: [B, T]`` (a query attends only to keys
of its own segment, an episode).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _block_mask(
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    causal: bool,
    q_seg: Optional[torch.Tensor] = None,
    kv_seg: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> Optional[torch.Tensor]:
    """``[B or 1, Tq, Tk]`` boolean mask combining causality, segment equality and a
    sliding window of the last ``window`` positions (which excludes the future by
    itself); ``None`` when nothing masks."""
    mask = None
    if causal:
        mask = kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        delta = q_pos[:, None] - kv_pos[None, :]
        w = (delta >= 0) & (delta < window)
        mask = w if mask is None else mask & w
    if mask is not None:
        mask = mask[None]
    if q_seg is not None:
        seg = q_seg[:, :, None] == kv_seg[:, None, :]
        mask = seg if mask is None else mask & seg
    return mask


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Softmax attention in float32 over ``[B, T, H, D]`` inputs, returned in ``q``'s
    dtype. A masked score is float32's lowest value and its weight is zeroed after the
    softmax, so a row with every key masked attends to nothing."""
    B, T, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s / math.sqrt(D)  # a Python float: no host tensor to copy inside a captured graph
    pos = torch.arange(T, device=q.device)
    mask = _block_mask(pos, pos, causal, segment_ids, segment_ids, window)
    if mask is not None:
        s = torch.where(mask[:, None], s, torch.finfo(torch.float32).min)
    p = torch.softmax(s, -1)
    if mask is not None:
        p = torch.where(mask[:, None], p, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
