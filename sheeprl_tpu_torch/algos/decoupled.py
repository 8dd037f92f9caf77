"""What the two thread-decoupled entries share (``sac_decoupled``, ``ppo_decoupled``;
counterparts of ``sheeprl_tpu/algos/{sac,ppo}/*_decoupled.py`` in their default
``distributed.mode=thread``): the player thread and the streams.

The reference runs its player and learner as two threads of one process and leans on
JAX for their safety: immutable buffers, ordered asynchronous dispatch, and a host lock
(``ring_lock``) around a donating scatter. The port's learner replays captured steps
that update the parameters in place, and a host lock orders launches, not the card's
work. So here each role launches on a CUDA stream of its own (a new thread would start
on the default stream and serialise against everything), and what crosses between them
is ordered by events: ``distributed/publish.py`` for tensors, ``StreamFence`` for the
device ring that both roles touch.

``PlayerThread`` runs the player's body on its stream. An exception there reaches the
learner through the queue of items (``take`` raises it), a ``stop`` event ends the body
at its next check, and ``close`` joins the thread within ``JOIN_SECONDS``; a player
still alive after that makes the entry raise, as the reference's does. The player draws
from a generator of its own, seeded ``seed + 10_000`` (the reference's key, rank 0);
the learner keeps ``ctx.rng()``'s generators, which are not shared with the player.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Any, Callable, Iterator, Optional

import torch

PLAYER_SEED_OFFSET = 10_000
POLL_SECONDS = 0.1  # how often a blocked queue operation looks at the stop event
JOIN_SECONDS = 30.0


def player_generator(cfg, device: torch.device) -> torch.Generator:
    """The player's own generator (``ctx.rng()`` belongs to the learner)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg.seed) + PLAYER_SEED_OFFSET)
    return gen


def role_stream(device: torch.device) -> Optional[torch.cuda.Stream]:
    """A CUDA stream of its own for a role on a card; None on the CPU."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def on_stream(stream: Optional[torch.cuda.Stream]):
    """``torch.cuda.stream(stream)``, or nothing on the CPU."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


class StreamFence:
    """Orders, on the device, the work that threads launch on one shared resource (the
    SAC player's writes into the device ring, the learner's blocks that read it): each
    holder's work waits for the previous holder's, whatever stream either ran on, so no
    block reads a row that is half written. The lock orders the launches; the event
    recorded after each holder orders the card's work. On the CPU the lock alone does."""

    def __init__(self):
        self._lock = threading.Lock()
        self._event: Optional[torch.cuda.Event] = None

    @contextlib.contextmanager
    def hold(self, stream: Optional[torch.cuda.Stream]) -> Iterator[None]:
        """Run the block's launches on ``stream`` after the previous holder's work."""
        with self._lock:
            if stream is None:
                yield
                return
            with torch.cuda.stream(stream):
                if self._event is not None:
                    stream.wait_event(self._event)
                yield
                self._event = torch.cuda.Event()
                self._event.record(stream)


class PlayerThread:
    """The player role on a daemon thread. ``body(thread)`` runs there on the player's
    stream (``thread.stream``) and hands its items to the learner with ``put``; it
    returns when ``thread.stop`` is set. ``items`` is the bounded queue the learner
    ``take``s from."""

    def __init__(self, name: str, body: Callable[["PlayerThread"], None], device: torch.device):
        self.items: "queue.Queue[Any]" = queue.Queue(maxsize=2)  # the reference's bound
        self.stop = threading.Event()
        self.stream = role_stream(device)
        self._body = body
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        try:
            with on_stream(self.stream):
                self._body(self)
        except Exception as exc:  # handed to the learner, which raises it
            self.put(exc)

    def put(self, item: Any) -> bool:
        """Queue ``item`` for the learner; False if stopped first."""
        while not self.stop.is_set():
            try:
                self.items.put(item, timeout=POLL_SECONDS)
                return True
            except queue.Full:
                continue
        return False

    def get_from(self, q: "queue.Queue") -> Any:
        """The player's blocking read of ``q`` (PPO's wait for a publication); None if
        stopped first."""
        while not self.stop.is_set():
            try:
                return q.get(timeout=POLL_SECONDS)
            except queue.Empty:
                continue
        return None

    def take(self) -> Any:
        """The learner's next item; raises the player's exception, or an error if the
        thread ended without handing one over."""
        while True:
            try:
                item = self.items.get(timeout=POLL_SECONDS)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self.items.empty():
                    raise RuntimeError(f"the decoupled player thread {self._thread.name!r} ended before its last item")
        if isinstance(item, BaseException):
            raise item
        return item

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def close(self) -> None:
        """Stop the body and join the thread within ``JOIN_SECONDS``."""
        self.stop.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=JOIN_SECONDS)

    def check_closed(self) -> None:
        """After ``close``: the reference's shutdown check."""
        if self.alive:
            raise RuntimeError("decoupled player thread did not shut down cleanly")
