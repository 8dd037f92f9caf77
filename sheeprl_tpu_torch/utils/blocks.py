"""An iteration's gradient steps as one block of replays (counterpart of
``sheeprl_tpu/utils/blocks.py``).

The reference runs a block of G gradient steps as one jitted ``lax.scan``. Here a block
is G replays of the captured step (``utils/graphs.py``) with no host sync between them:

* the block's step table, ``[G, W]`` int64, goes to the device in one asynchronous copy
  from pinned memory: each row is a step's (env, start) replay indices (device replay)
  followed by its target-critic flag, or the flag alone (host replay);
* before each replay one device copy puts row g into the graph's static ``table`` input,
  the host path's batch g (row g of the block's ``[G, T, B, ...]`` tensors) is copied
  into the static batch, and the step's draws are written into the static draws from
  the run's generator;
* the flags come from the cumulative step count before the block, ``start_count``, as
  the reference computes them: step g updates the target critic when
  ``(start_count + count_offset + g) % freq == 0`` (``count_offset=1`` tests the count
  after the increment, as DreamerV3 does);
* the block returns the LAST step's metrics, cloned: the captured step's outputs are
  static tensors that the next replay overwrites.

``chunk_sizes`` decomposes G into powers of two as the reference does. A replay costs
the same whatever G is, so here the chunks only bound how many steps one table holds.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.utils.graphs import StepGraph


def chunk_sizes(n: int, max_chunk: int = 8) -> List[int]:
    """Decompose ``n`` into descending powers of two <= ``max_chunk``."""
    if n <= 0:
        return []
    out: List[int] = []
    size = max_chunk
    while n > 0 and size > 1:
        while n >= size:
            out.append(size)
            n -= size
        size //= 2
    out.extend([1] * n)
    return out


def target_flags(start_count: int, n: int, target_update_freq: int = 1, count_offset: int = 1) -> np.ndarray:
    """Whether each of ``n`` steps starting after ``start_count`` updates the target
    critic (the reference's ``make_train_block`` cadence)."""
    freq = max(int(target_update_freq), 1)
    return (start_count + count_offset + np.arange(n)) % freq == 0


def _upload(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host int64 table on ``device``: from pinned memory, without waiting, on a card."""
    t = torch.from_numpy(np.ascontiguousarray(table, dtype=np.int64))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def make_train_block(
    step: StepGraph,
    draw: Callable[[Any], Any],
    target_update_freq: int = 1,
    count_offset: int = 1,
    select: Optional[Callable[[int], StepGraph]] = None,
) -> Callable[..., Tuple[List[str], torch.Tensor]]:
    """Wrap a captured step into ``block(start_count, n, index_rows=None, batches=None)``.

    ``step.inputs`` holds ``table`` (int64 ``[W]``: the index row, then the flag),
    ``draws`` (filled by ``draw(step.inputs["draws"])`` before each replay) and, for host
    replay, ``batch``. ``index_rows`` is ``[n, W - 1]`` (device replay) and ``batches``
    a dict of ``[n, T, B, ...]`` (or ``[n, B, ...]``) tensors on the device (host
    replay). ``select(count)``, where given, is the captured step to replay at the
    cumulative step count ``count`` (SAC-AE: one graph per pattern of its update
    cadences), every one over ``step.inputs``. Returns the last step's metric names and
    their values, one float32 tensor on the device."""
    table_in: torch.Tensor = step.inputs["table"]
    static_batch: Optional[Dict[str, torch.Tensor]] = step.inputs.get("batch")

    def block(start_count: int, n: int, index_rows: Optional[np.ndarray] = None, batches: Optional[Dict[str, torch.Tensor]] = None):
        flags = target_flags(start_count, n, target_update_freq, count_offset)[:, None]
        table = flags if index_rows is None else np.concatenate([np.asarray(index_rows), flags], 1)
        table = _upload(table, step.device)
        metrics: Dict[str, torch.Tensor] = {}
        for g in range(n):
            table_in.copy_(table[g], non_blocking=True)
            if static_batch is not None:
                for k, buf in static_batch.items():
                    buf.copy_(batches[k][g], non_blocking=True)
            draw(step.inputs["draws"])
            metrics = (step if select is None else select(start_count + g))()
        names = list(metrics)
        return names, torch.stack([metrics[k].detach().float() for k in names])

    return block


class WindowedFutures:
    """Deferred metrics and the window's gradient steps per second.

    The loop ``track()``s each block's metrics (device tensors, no sync), ``drain()``s
    them into the aggregator at the log cadence (the window's only blocking copy to the
    host) and reads ``pop_window_sps()``: gradient steps over the window's wall time."""

    def __init__(self, max_pending: int = 256, max_spill: int = 8192):
        self._pending: List[Tuple[List[str], torch.Tensor]] = []
        self._spill: List[Dict[str, float]] = []  # metrics fetched early (backlog cap)
        self._max_pending = max_pending
        self._max_spill = max_spill
        self._warned_trim = False
        self._window_grad_steps = 0
        self._window_t0 = 0.0

    def _fetch(self) -> List[Dict[str, float]]:
        if not self._pending:
            return []
        flat = torch.cat([v.reshape(-1) for _, v in self._pending]).cpu().tolist()
        out, i = [], 0
        for names, _ in self._pending:
            out.append(dict(zip(names, flat[i : i + len(names)])))
            i += len(names)
        self._pending.clear()
        return out

    def track(self, metrics: Tuple[List[str], torch.Tensor], n_steps: int) -> None:
        if self._window_grad_steps == 0:
            self._window_t0 = time.perf_counter()
        self._pending.append(metrics)
        self._window_grad_steps += n_steps
        if len(self._pending) >= self._max_pending:
            # bound the backlog of device tensors between drains; a drain still
            # aggregates what was fetched, and only without drains is the spill trimmed
            self._spill.extend(self._fetch())
            if len(self._spill) > self._max_spill:
                if not self._warned_trim:
                    self._warned_trim = True
                    logging.getLogger(__name__).warning(
                        "metrics window exceeded %d gradient blocks without a drain; oldest entries dropped "
                        "(lower metric.log_every to keep full window statistics).",
                        self._max_spill,
                    )
                del self._spill[: len(self._spill) - self._max_spill]

    def drain(self, aggregator) -> None:
        fetched = self._spill + self._fetch()
        self._spill.clear()
        if aggregator is not None:
            for chunk in fetched:
                for k, v in chunk.items():
                    aggregator.update(k, float(v))

    def pop_window_sps(self) -> Optional[float]:
        if self._window_grad_steps == 0:
            return None
        sps = self._window_grad_steps / max(time.perf_counter() - self._window_t0, 1e-9)
        self._window_grad_steps = 0
        return sps


class BlockDispatcher:
    """Host replay: an iteration's gradient steps as chunks of replays over batches the
    prefetcher sampled and copied to the device; metrics stay on the device until
    ``drain``."""

    def __init__(
        self, step: StepGraph, draw: Callable, target_update_freq: int = 1, max_chunk: int = 8, count_offset: int = 1,
        select: Optional[Callable[[int], StepGraph]] = None,
    ):
        self._block = make_train_block(step, draw, target_update_freq, count_offset, select)
        self._max_chunk = max_chunk
        self._futures = WindowedFutures()

    def dispatch(self, batches: Dict[str, torch.Tensor], start_count: int) -> None:
        """Run ``G`` steps over ``batches``, a dict of ``[G, T, B, ...]`` tensors."""
        offset = 0
        for size in chunk_sizes(len(next(iter(batches.values()))), self._max_chunk):
            metrics = self._block(start_count, size, batches={k: v[offset : offset + size] for k, v in batches.items()})
            offset += size
            start_count += size
            self._futures.track(metrics, size)

    def track(self, metrics: Tuple[List[str], torch.Tensor]) -> None:
        """Defer the metrics of a step run beside the blocks (DroQ's actor step)."""
        self._futures.track(metrics, 0)

    def drain(self, aggregator) -> None:
        self._futures.drain(aggregator)

    def pop_window_sps(self) -> Optional[float]:
        return self._futures.pop_window_sps()


class IndexedBlockDispatcher(BlockDispatcher):
    """Device replay: the host ships only ``[G, B]`` (env, start) index arrays; each
    replay gathers its ``[T, B]`` batch from the device mirror inside the graph (the SAC
    family: (env, row) pairs and a ``[B]`` row gather from its transition ring)."""

    def dispatch(self, envs: np.ndarray, starts: np.ndarray, start_count: int) -> None:
        rows = np.concatenate([np.asarray(envs, np.int64), np.asarray(starts, np.int64)], 1)
        offset = 0
        for size in chunk_sizes(rows.shape[0], self._max_chunk):
            metrics = self._block(start_count, size, index_rows=rows[offset : offset + size])
            offset += size
            start_count += size
            self._futures.track(metrics, size)

