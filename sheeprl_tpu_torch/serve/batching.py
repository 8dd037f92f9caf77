"""Continuous batching on the host (counterpart of ``sheeprl_tpu/serve/batching.py``,
copied nearly as it stands): the bucket ladder, batch collection and padding.

The ladder is a small set of batch sizes (powers of two up to ``serve.max_batch_size``,
or ``serve.buckets``); every dispatch pads its request batch to the smallest bucket that
fits, so the only shapes the device sees are the ladder's, each captured as one CUDA
graph at startup (``serve/precompile.py``). The first queued request opens a batch and
starts the ``max_batch_delay_ms`` clock; the batch dispatches when it is full or the
clock runs out. Standard library and numpy only.
"""

from __future__ import annotations

import queue
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def bucket_ladder(max_batch: int, explicit: Optional[Sequence[int]] = None) -> List[int]:
    """The sorted batch-size ladder: powers of two up to ``max_batch`` (which is
    always included), or a validated explicit ladder (``serve.buckets``)."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if explicit:
        ladder = sorted({int(b) for b in explicit})
        if ladder[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {ladder}")
        if ladder[-1] != max_batch:
            raise ValueError(
                f"explicit ladder {ladder} must top out at serve.max_batch_size={max_batch}"
            )
        return ladder
    ladder = []
    b = 1
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return ladder


def pick_bucket(ladder: Sequence[int], n: int) -> int:
    """Smallest ladder bucket that fits ``n`` requests."""
    for b in ladder:
        if n <= b:
            return int(b)
    raise ValueError(f"batch of {n} exceeds the ladder maximum {ladder[-1]}")


def collect_batch(
    q: "queue.Queue",
    max_batch: int,
    delay_s: float,
    first_timeout_s: float = 0.1,
) -> List[Any]:
    """Pull one continuous batch off ``q``.

    Blocks up to ``first_timeout_s`` for the first item (an empty list means idle
    — the caller re-checks its shutdown flag and loops).  Once a batch is open,
    keeps pulling until it holds ``max_batch`` items or ``delay_s`` has passed
    since the batch opened.
    """
    try:
        batch = [q.get(timeout=first_timeout_s)]
    except queue.Empty:
        return []
    deadline = time.monotonic() + max(float(delay_s), 0.0)
    while len(batch) < max_batch:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        try:
            batch.append(q.get(timeout=remaining))
        except queue.Empty:
            break
    return batch


def pad_obs_batch(
    obs_list: Sequence[Dict[str, np.ndarray]],
    template: Dict[str, Tuple[Tuple[int, ...], str]],
    bucket: int,
) -> Dict[str, np.ndarray]:
    """Stack per-request obs dicts into one zero-padded ``[bucket, ...]`` batch.

    Every request's arrays are cast to the policy's template dtypes (clients may
    send float64 rewards-of-habit numpy); rows past ``len(obs_list)`` stay zero —
    their outputs are computed and discarded, which is the price of pinned shapes.
    """
    if len(obs_list) > bucket:
        raise ValueError(f"{len(obs_list)} requests do not fit bucket {bucket}")
    out: Dict[str, np.ndarray] = {}
    for key, (shape, dtype) in template.items():
        arr = np.zeros((bucket, *shape), dtype=np.dtype(dtype))
        for i, obs in enumerate(obs_list):
            if key not in obs:
                raise KeyError(f"request {i} is missing obs key {key!r}")
            row = np.asarray(obs[key], dtype=np.dtype(dtype))
            if row.shape != tuple(shape):
                raise ValueError(
                    f"obs key {key!r}: request shape {row.shape} != policy shape {tuple(shape)}"
                )
            arr[i] = row
        out[key] = arr
    return out
