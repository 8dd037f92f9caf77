"""Replay sampling on a worker thread (counterpart of ``sheeprl_tpu/data/prefetch.py``).

``AsyncBatchPrefetcher`` keeps one sample request in flight on a worker thread: while
the device runs the current iteration's gradient steps, the worker draws the next
iteration's batches and copies them to the device. ``get(n)`` returns the staged block
(a dict of ``[n, T, B, ...]`` tensors) when it holds at least ``n`` steps (cutting off
the extra ones) and queues the next request at once.

Coherency: the worker samples under ``self.lock``; the training loop takes the same
lock around every ``rb.add`` so the worker never reads a row mid-write. The staged block
was sampled one iteration early, so it misses that iteration's newest rows.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Any, Callable, Optional

from sheeprl_tpu_torch.data.buffers import to_device


class AsyncBatchPrefetcher:
    def __init__(self, sample_fn: Callable[[int], Any]):
        self.lock = threading.Lock()
        self._sample_fn = sample_fn
        self._req: "queue.Queue[Optional[int]]" = queue.Queue(maxsize=1)
        self._res: "queue.Queue[Any]" = queue.Queue(maxsize=1)
        self._pending_n: Optional[int] = None
        self._thread = threading.Thread(target=self._work, name="batch-prefetch", daemon=True)
        self._thread.start()

    def _work(self) -> None:
        while True:
            n = self._req.get()
            if n is None:
                return
            try:
                with self.lock:
                    block = self._sample_fn(n)
            except Exception as exc:  # raised on the consumer's next get()
                block = exc
            self._res.put(block)

    def get(self, n: int, stage_next: bool = True) -> Any:
        """An ``n``-step block: the staged one if it is large enough, else one sampled
        now. ``stage_next=False`` on the last iteration samples nothing more."""
        if self._pending_n is not None and self._pending_n >= n:
            block = self._res.get()
            self._pending_n = None
            if isinstance(block, Exception):
                raise block
            block = {k: v[:n] for k, v in block.items()}
        else:
            if self._pending_n is not None:
                self._res.get()  # drop the too-small block in flight
                self._pending_n = None
            with self.lock:
                block = self._sample_fn(n)
        if stage_next:
            self._req.put(n)
            self._pending_n = n
        return block

    def close(self) -> None:
        if self._pending_n is not None:
            try:
                self._res.get(timeout=10)
            except queue.Empty:
                pass
            self._pending_n = None
        try:
            self._req.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=10)


def make_replay_prefetcher(rb, device, cfg, batch_size: int, sequence_length: int):
    """The loop's sampler: ``sample_block(n)`` draws ``n`` gradient steps' worth of
    ``[T, B, ...]`` batches, as a dict of ``[n, T, B, ...]`` tensors on ``device`` (one
    copy per key).
    Wrapped in a prefetcher when ``algo.async_prefetch`` is on. Returns
    ``(prefetcher_or_None, rb_lock, sample_block)``; the loop takes ``rb_lock`` around
    every ``rb.add``."""

    def sample_block(n: int):
        return to_device(rb.sample(batch_size, sequence_length=sequence_length, n_samples=n), device)

    if cfg.algo.get("async_prefetch", True):
        prefetcher = AsyncBatchPrefetcher(sample_block)
        return prefetcher, prefetcher.lock, sample_block
    return None, contextlib.nullcontext(), sample_block
