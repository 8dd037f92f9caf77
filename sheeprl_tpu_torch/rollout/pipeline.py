"""``PipelinedPlayer``: overlap the policy on the device with env stepping on the host
(counterpart of ``sheeprl_tpu/rollout/pipeline.py``).

* ``depth=0``: synchronous. Each ``act`` runs the policy, copies its outputs to the
  host and returns them: the plain acting path. On a card the copy goes through pinned
  memory and waits on an event recorded after it on the current stream, so the host
  waits for this stream's work only, not for other threads' streams.
* ``depth=k>=1``: policy lag. Each ``act`` launches the policy on the newest
  observation, starts the copy of its outputs into pinned host memory at once (a
  ``non_blocking`` copy, then a CUDA event: the counterpart of the reference's
  ``copy_to_host_async``), and returns the outputs of the call made ``k`` calls ago,
  waiting only on that call's event. The card computes action ``t + 1`` while the envs
  step ``t``. While the pipeline fills, the first ``k`` calls return the first call's
  outputs again. The action applied at step ``t`` comes from observation ``t - k``; an
  on-policy loss then trains on slightly stale log-probs and values, as in the
  reference.

The caller keeps the algorithm's state: ``policy(*args)`` returns a tuple of tensors and
``postprocess(host_arrays) -> (env_actions, payload)`` turns the fetched numpy arrays
into the env's actions (clipping, squeezing) and whatever the loop stores.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _default_postprocess(fetched: Any) -> Tuple[Any, Any]:
    return fetched, None


class _HostCopy:
    """One call's outputs on their way to the host: pinned buffers and the event
    recorded after their copies (CUDA), or copies taken at once (CPU)."""

    def __init__(self, tensors: Sequence[torch.Tensor], buffers: Optional[List[torch.Tensor]]):
        self.event = None
        if buffers is None:
            self.host = [t.detach().cpu().clone() for t in tensors]
            return
        for buf, t in zip(buffers, tensors):
            buf.copy_(t.detach(), non_blocking=True)
        self.host = buffers
        self.event = torch.cuda.Event()
        self.event.record()

    def wait(self) -> Tuple[np.ndarray, ...]:
        if self.event is not None:
            self.event.synchronize()
        return tuple(t.numpy().copy() for t in self.host)


class PipelinedPlayer:
    def __init__(self, envs: Any, policy: Callable[..., Sequence[torch.Tensor]], postprocess: Optional[Callable] = None, depth: int = 0):
        if depth < 0:
            raise ValueError(f"pipeline_depth must be >= 0, got {depth}")
        self.envs = envs
        self.depth = int(depth)
        self._policy = policy
        self._post = postprocess or _default_postprocess
        self._queue: deque = deque()
        # depth + 2 sets of pinned buffers, used in turn: a set is written again only
        # after its call has been fetched
        self._slots: List[Optional[List[torch.Tensor]]] = [None] * (self.depth + 2)
        self._next_slot = 0

    def _buffers(self, tensors: Sequence[torch.Tensor]) -> Optional[List[torch.Tensor]]:
        if not tensors or not tensors[0].is_cuda:
            return None
        i = self._next_slot
        self._next_slot = (i + 1) % len(self._slots)
        slot = self._slots[i]
        if slot is None or [(b.shape, b.dtype) for b in slot] != [(t.shape, t.dtype) for t in tensors]:
            slot = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            self._slots[i] = slot
        return slot

    def act(self, *args: Any, **kwargs: Any) -> Tuple[Any, Any]:
        """Run the policy; return ``(env_actions, payload)``: this call's at depth 0, the
        call's ``depth`` calls ago otherwise."""
        out = tuple(self._policy(*args, **kwargs))
        if self.depth == 0:
            return self._post(_HostCopy(out, self._buffers(out)).wait())
        self._queue.append(_HostCopy(out, self._buffers(out)))
        fut = self._queue.popleft() if len(self._queue) > self.depth else self._queue[0]
        return self._post(fut.wait())

    def env_step(self, actions: Any):
        """Step the vector env; with ``depth >= 1`` the card computes the next action
        meanwhile."""
        return self.envs.step(actions)

    def step(self, *args: Any, **kwargs: Any):
        """``act`` then ``env_step``, for loops with nothing between them."""
        env_actions, payload = self.act(*args, **kwargs)
        return env_actions, payload, self.env_step(env_actions)

    def reset_pipeline(self) -> None:
        """Drop the queued calls (when the caller rebuilds its env state)."""
        self._queue.clear()
