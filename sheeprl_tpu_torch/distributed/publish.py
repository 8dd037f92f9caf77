"""Parameter publication between a decoupled entry's learner and its player
(counterpart of the thread path of ``sheeprl_tpu/distributed/publish.py``).

The contract is the reference's: **freshest wins** (``evict_and_put``: a publication
never queues behind an older one) and **stamped** (``make_stamp``: ``{seq, grad_step,
policy_step}``, from which the player's ``staleness_steps`` is logged as
``Sebulba/param_staleness_steps``). The reference publishes ``jnp.copy``s and leans on
JAX's immutable buffers and ordered dispatch. Here the learner's captured steps update
their parameters in place on the learner's CUDA stream while the player acts on its own
stream, so what a publication carries is made safe by streams and events:

* ``handoff(tensors, device)`` records a CUDA event on the producer's current stream
  after the work that wrote ``tensors``; ``publish`` first copies them on that stream,
  so the learner's next in-place update cannot reach what the player reads;
* ``receive`` makes the consumer's current stream wait on that event and marks each
  tensor as used by that stream (``Tensor.record_stream``), so the caching allocator
  does not hand the memory to the producer's next work while the consumer still reads
  it; ``adopt`` then copies a publication into the consumer's own tensors;
* ``ready`` asks, without waiting, whether the producer's work has finished;
  ``take_newest_ready`` picks the newest finished one of a player's pending
  publications.

On the CPU there are no streams: every operation has finished when it returns, so a
hand-off carries no event. The Sebulba publishers (channels, device placement) are not
ported.
"""

from __future__ import annotations

import queue
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import torch


def make_stamp(seq: int, grad_step: int, policy_step: int) -> Dict[str, int]:
    return {"seq": int(seq), "grad_step": int(grad_step), "policy_step": int(policy_step)}


def staleness_steps(stamp: Optional[Dict[str, Any]], policy_step: int) -> Optional[int]:
    """Policy-step age of ``stamp``-ed params at the consumer's ``policy_step``."""
    if not stamp:
        return None
    return max(int(policy_step) - int(stamp.get("policy_step", policy_step)), 0)


def evict_and_put(q: "queue.Queue", item: Any) -> int:
    """Freshest-wins publish into a bounded queue: drop stale entries, never block.
    Returns how many stale publications were evicted (0 on the happy path)."""
    evicted = 0
    while True:
        try:
            q.put_nowait(item)
            return evicted
        except queue.Full:
            try:
                q.get_nowait()
                evicted += 1
            except queue.Empty:
                pass


class Publication(NamedTuple):
    """Tensors handed from one thread's stream to another's: ``event`` (None on the CPU)
    was recorded on the producer's stream after the work that wrote them."""

    tensors: List[torch.Tensor]
    event: Optional[torch.cuda.Event]
    stamp: Optional[Dict[str, int]] = None


def handoff(tensors: Sequence[torch.Tensor], device: torch.device, stamp: Optional[Dict[str, int]] = None) -> Publication:
    """Hand ``tensors`` (written by work already launched on the current stream) to a
    consumer on another stream."""
    event = None
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    return Publication(list(tensors), event, stamp)


def publish(tensors: Sequence[torch.Tensor], stamp: Dict[str, int]) -> Publication:
    """The learner's publication: copies of ``tensors`` taken on the current stream after
    the work launched on it so far, and the event after the copies."""
    with torch.no_grad():
        copies = [t.detach().clone() for t in tensors]
    return handoff(copies, copies[0].device, stamp)


def ready(pub: Publication) -> bool:
    """Whether the producer's work for ``pub`` has finished (never waits)."""
    return pub.event is None or pub.event.query()


def take_newest_ready(pending: List[Publication]) -> Optional[Publication]:
    """The newest publication of ``pending`` (oldest first, all from one producer stream,
    so they finish in order) whose producer's work has finished, removed from
    ``pending`` with every older one; None, and ``pending`` untouched, if none has."""
    for i in range(len(pending) - 1, -1, -1):
        if ready(pending[i]):
            pub = pending[i]
            del pending[: i + 1]
            return pub
    return None


def receive(pub: Publication, device: torch.device) -> List[torch.Tensor]:
    """The consumer's side: its current stream waits on the producer's event, and the
    tensors are marked as used by that stream. Returns the tensors."""
    if pub.event is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(pub.event)
        for t in pub.tensors:
            t.record_stream(stream)
    return pub.tensors


def adopt(pub: Publication, dst: Sequence[torch.Tensor]) -> None:
    """Copy a publication into ``dst`` (the player's own parameters) on the current
    stream, after the producer's event."""
    src = receive(pub, dst[0].device)
    with torch.no_grad():
        torch._foreach_copy_(list(dst), src)
