"""Per-session act state on the device for stateful (recurrent) policies (counterpart of
``sheeprl_tpu/serve/state_cache.py``).

A recurrent policy's act function is ``act_fn(params, obs, is_first, state) -> (actions,
new_state)``: the state (the LSTM carry or attention window, and the previous action)
survives between requests, per client. The cache keeps it on the device as one
preallocated tree of ``capacity + 1`` rows (row ``capacity`` is scratch) and maps
session ids to rows on the host:

* :meth:`assign` turns a batch's session ids into row indices and the ``is_first``
  column: a session seen before continues its episode (``is_first = 0``); a new, an
  evicted-and-returning or a ``reset`` session starts afresh (``is_first = 1``: the
  agent's step masks the stale row, so rows never need zeroing on the host);
* :meth:`gather` and :meth:`scatter` are the row gather and scatter that each bucket's
  CUDA graph runs around the step, from a static index tensor
  (``serve/precompile.py``);
* eviction is least-recently-used; requests without a session use the scratch row
  (``is_first = 1``), and the server pads short batches with the scratch index, so
  padding rows scatter there harmlessly.

A batch holding one session twice scatters both rows to one slot; which one lands is
not defined (``index_copy_`` with repeated indices). The serving fleet's
session-affine routing makes that a client pipelining its own requests.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.utils.graphs import tree_tensors


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return tuple(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))


class SessionStateCache:
    """Not thread-safe by design: owned by the server's dispatcher of one endpoint."""

    def __init__(self, zero_state_fn: Callable[[int], Any], capacity: int):
        self.capacity = int(capacity)
        self.scratch = self.capacity  # the extra row: session-less and padding traffic
        self.storage = zero_state_fn(self.capacity + 1)
        self._slots: "OrderedDict[str, int]" = OrderedDict()  # session -> row, LRU order
        self._free: List[int] = list(range(self.capacity))
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._slots)

    def assign(self, sessions: Sequence[Optional[str]], resets: Sequence[bool]) -> Tuple[np.ndarray, np.ndarray]:
        """Row index (int64) and ``is_first`` ``[n, 1]`` per request; updates the LRU
        order."""
        n = len(sessions)
        idx = np.full((n,), self.scratch, np.int64)
        is_first = np.ones((n, 1), np.float32)
        for i, (session, reset) in enumerate(zip(sessions, resets)):
            if session is None:
                continue  # scratch row, fresh state
            slot = self._slots.get(session)
            if slot is None:
                if self._free:
                    slot = self._free.pop()
                else:
                    _, slot = self._slots.popitem(last=False)  # evict the least recently used
                    self.evictions += 1
                self._slots[session] = slot
            else:
                self._slots.move_to_end(session)
                if not reset:
                    is_first[i, 0] = 0.0
            idx[i] = slot
        return idx, is_first

    def gather(self, idx: torch.Tensor) -> Any:
        return _tree_map(lambda s: s.index_select(0, idx), self.storage)

    def scatter(self, idx: torch.Tensor, rows: Any) -> None:
        _tree_map(lambda s, r: s.index_copy_(0, idx, r.to(s.dtype)), self.storage, rows)

    def tensors(self) -> List[torch.Tensor]:
        """The storage's tensors (what a graph capture saves and restores around its
        warm-up steps)."""
        return tree_tensors(self.storage)

    def stats(self) -> dict:
        return {"capacity": self.capacity, "sessions": len(self._slots), "evictions": self.evictions}
