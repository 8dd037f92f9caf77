"""Parameter publication between a decoupled entry's learner and its player or actors
(counterpart of ``sheeprl_tpu/distributed/publish.py``).

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
hand-off carries no event.

Sebulba's actors are processes of their own, so the learner publishes over their
channels (``ChannelWeightPublisher``): one copy to the host per publication
(``host_arrays``), sent as numpy arrays by parameter name to every live channel, and
to a channel that connects later (``maybe_welcome``). The reference's
``DeviceWeightPublisher`` serves its thread path, where the port hands tensors off by
events (above): it is not ported.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.distributed.transport import Channel, ChannelClosed

#: the message kind of a stamped parameter publication on the wire
PARAMS_KIND = "params"


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


def host_arrays(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``{name: numpy array}`` of ``tensors`` through one copy to the host: their bytes
    are packed into one buffer on their device, copied once, and viewed back as arrays
    of their dtypes and shapes. A dtype numpy lacks (bfloat16) raises."""
    names = list(tensors)
    flat = [tensors[n].detach().contiguous() for n in names]
    for n, t in zip(names, flat):
        if t.dtype == torch.bfloat16:
            raise TypeError(f"{n}: a bfloat16 tensor has no numpy dtype to publish")
    if not flat:
        return {}
    with torch.no_grad():
        packed = torch.cat([t.reshape(-1).view(torch.uint8) for t in flat]).cpu().numpy()
    out, offset = {}, 0
    for n, t in zip(names, flat):
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        nbytes = t.numel() * t.element_size()
        out[n] = packed[offset : offset + nbytes].view(dtype).reshape(tuple(t.shape))
        offset += nbytes
    return out


class ChannelWeightPublisher:
    """The Sebulba learner's publisher: one copy to the host per publication, sent to
    every live actor channel (``channels()``), the last one kept for channels that
    connect later. A dead channel is skipped: its actor's respawn gets the welcome."""

    def __init__(self, channels: Callable[[], Iterable[Channel]]):
        self._channels = channels
        self._lock = threading.Lock()
        self._last: Optional[Tuple[Any, Dict[str, int]]] = None
        self.seq = 0
        self.bytes_published = 0
        self.host_seconds = 0.0  # the copies to the host, over every publication
        self.send_seconds = 0.0  # the sends, over every publication

    def publish(self, params: Any, *, grad_step: int, policy_step: int) -> Dict[str, int]:
        """Publish ``params``: ``{name: tensor}``, or a dict of such dicts (SAC's
        ``{"actor": ...}``). Returns the stamp."""
        t0 = time.perf_counter()
        # the one copy to the host, outside the lock: it waits for the device's work, and
        # nothing it reads is shared
        if all(isinstance(v, torch.Tensor) for v in params.values()):
            host = host_arrays(params)
        else:
            host = {k: host_arrays(v) for k, v in params.items()}
        t1 = time.perf_counter()
        with self._lock:
            self.seq += 1
            stamp = make_stamp(self.seq, grad_step, policy_step)
            self._last = (host, stamp)
            channels = list(self._channels())
        # the sends hold no lock: a backpressured actor socket must not hold up a welcome
        # on the accept thread. So two sends may reach a channel out of order; the
        # consumer keeps the highest seq (sebulba._freshest).
        sent = 0
        for ch in channels:
            try:
                sent += ch.send(PARAMS_KIND, host, stamp=stamp, t_pub=time.time())
            except ChannelClosed:
                pass
        with self._lock:
            self.bytes_published += sent
            self.host_seconds += t1 - t0
            self.send_seconds += time.perf_counter() - t1
        return stamp

    def maybe_welcome(self, ch: Channel) -> None:
        """Send the last publication to a channel that has just connected (a respawned
        actor must not act on its initial parameters when trained ones exist); nothing
        before the first publication (every actor builds the learner's initial
        parameters from the shared seed)."""
        with self._lock:
            last = self._last
        if last is None:
            return
        host, stamp = last
        try:
            sent = ch.send(PARAMS_KIND, host, stamp=stamp, t_pub=time.time())
        except ChannelClosed:
            return
        with self._lock:
            self.bytes_published += sent
