"""Sebulba roles: the actor and learner process bodies of the decoupled entries
(counterpart of ``sheeprl_tpu/distributed/sebulba.py``; Podracer's Sebulba topology,
arXiv 2104.06272 §3).

``distributed.mode=sebulba`` places ``sac_decoupled``'s and ``ppo_decoupled``'s two roles
in processes of their own, joined by the framed channel of ``transport.py``. On one
card every process has a CUDA context of its own on device 0:

* **an actor** (``distributed.role=actor``, one process per ``actor_id``) owns its env
  shard (seeded by ``rank=actor_id``, as ``make_vector_env`` seeds ranks) and, for SAC,
  its replay shard (``buffer.size // (num_envs * num_actors)`` rows, seeded
  ``seed + actor_id``). It acts with draws of its own (``seed + 10_000 + actor_id``,
  the thread player's offset) on the newest parameters it has received, copied into its
  module's own tensors (never rebound), and sends its blocks to the learner: SAC's
  ``[G, B, ...]`` samples, PPO's rollout batch with GAE computed on its device.
* **the learner** (``distributed.role=learner``) accepts the actors' channels, takes
  blocks from one bounded inbox (TCP backpressure throttles the actors when it fills),
  runs the thread path's update (SAC's captured step replayed as a ``G``-step block over
  the block copied to the card through pinned memory; PPO's captured update) and
  publishes its parameters back (``publish.ChannelWeightPublisher``: one copy to the
  host per publication).

With one actor and the same seed, PPO's lockstep (the actor waits for the publication
of the update its batch feeds) gives the learner the thread path's batches byte for
byte: each per-iteration count uses ``num_actors`` where the thread path has one player.
A SIGKILLed actor closes its channel; the learner goes on with the other channels (no
barrier on the block path) while the launcher (``launcher.py``) respawns the actor with
a bumped generation, which reconnects, gets the latest parameters as a welcome and
refills its replay shard from nothing.

The learner writes a summary to ``SHEEPRL_TPU_SEBULBA_SUMMARY`` when it ends, also on a
crash: counts, the gradient-step trace, the channels' lifecycle events, and here also
the publications' host and send times, the staleness, each process's kernel launch
counts and peak device memory, and each actor's ``Rollout/*`` (its env pool's counters,
``{}`` without one; an actor shards ``env.pool.num_workers`` with ``shard_pool_cfg``). The learner ends each message at the training guard's
boundary (``fault/guard.py``): a forwarded SIGTERM ends it there with a checkpoint, the
``PREEMPTED`` marker and ``Preempted``, which its train entry turns into exit 75. Not
ported: the reference's flight recorder, monitor, fleet exporter and span tracer
(``obs.*`` is refused by name).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import queue
import threading
import time
from pathlib import Path
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.distributed.placement import SUMMARY_ENV_VAR, PlacementSpec
from sheeprl_tpu_torch.distributed.publish import PARAMS_KIND, ChannelWeightPublisher, host_arrays, staleness_steps
from sheeprl_tpu_torch.distributed.transport import Channel, ChannelClosed, FramingError, Listener, connect, maybe_digest
from sheeprl_tpu_torch.rollout.pool import rollout_metrics
from sheeprl_tpu_torch.rollout.sharding import shard_pool_cfg

HELLO_KIND = "hello"
BLOCK_KIND = "block"
DONE_KIND = "done"
ABANDON_KIND = "abandon"

#: the inbox depth in blocks, the staleness of the parameters each block was acted with,
#: and the bytes received (per channel with a ``/ch<actor_id>`` suffix)
SEBULBA_METRIC_KEYS = frozenset({"Sebulba/queue_depth", "Sebulba/param_staleness_steps", "Sebulba/xfer_bytes"})


# ----------------------------------------------------------------------- inbox
class LearnerInbox:
    """An accept loop and one reader thread per actor channel, all feeding one bounded
    queue of ``distributed.queue_depth`` blocks. When the learner falls behind, readers
    block on ``put``, the sockets' buffers fill and every actor's ``send`` stalls. A dead
    actor never wedges the learner: its reader ends with ``ChannelClosed`` and queues a
    ``closed`` item of that generation instead of a block, stamped with the time it saw
    the end of the stream, also when a respawn has replaced the channel by then."""

    def __init__(self, listener: Listener, spec: PlacementSpec, on_connect: Optional[Callable[[Channel], None]] = None):
        self._listener = listener
        self._spec = spec
        self._q: "queue.Queue[Tuple[str, int, Dict[str, Any], Any]]" = queue.Queue(maxsize=spec.queue_depth)
        self._lock = threading.Lock()
        self._channels: Dict[int, Channel] = {}
        self._bytes_drained = 0
        self._stop = threading.Event()
        #: [monotonic t, actor_id, generation, event]: the summary's lifecycle trace
        self.events: List[List[Any]] = []
        self.on_connect = on_connect
        self._accept_thread = threading.Thread(target=self._accept_loop, name="sebulba-accept", daemon=True)
        self._accept_thread.start()

    def channels(self) -> List[Channel]:
        with self._lock:
            return list(self._channels.values())

    def qsize(self) -> int:
        return self._q.qsize()

    def bytes_received(self) -> int:
        # a closed channel folds its total into _bytes_drained once, in its reader's finally
        with self._lock:
            return self._bytes_drained + sum(ch.bytes_received for ch in self._channels.values())

    def record(self, actor_id: int, generation: int, event: str, t: Optional[float] = None) -> None:
        """Add an event at monotonic time ``t`` (now by default), the list kept in time
        order."""
        with self._lock:
            bisect.insort(self.events, [time.monotonic() if t is None else float(t), int(actor_id), int(generation), event],
                          key=lambda e: e[0])

    def get(self, timeout: Optional[float] = None) -> Tuple[str, int, Dict[str, Any], Any]:
        """The next item. A ``closed`` item stays queued after every block its actor sent
        before it; when the learner takes it, it is recorded as an event at the time its
        reader saw the end of the stream (``_eof_t``, taken out of the item's meta), as
        the reference records it."""
        item = self._q.get(timeout=timeout)
        if item[0] == "closed":
            self.record(item[1], item[2]["generation"], "closed", t=item[2].pop("_eof_t"))
        return item

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                ch = self._listener.accept(timeout=0.5)
            except TimeoutError:
                continue
            except OSError:
                return
            threading.Thread(target=self._reader, args=(ch,), daemon=True).start()

    def _reader(self, ch: Channel) -> None:
        actor_id: Optional[int] = None
        generation = 0
        done = False
        try:
            kind, meta, _ = ch.recv(timeout=self._spec.connect_timeout_s)
            if kind == ABANDON_KIND:
                # the launcher gave up respawning this slot: the learner stops waiting for it
                self._q.put((ABANDON_KIND, int(meta["actor_id"]), dict(meta), None))
                return
            if kind != HELLO_KIND:
                return
            actor_id = int(meta["actor_id"])
            generation = int(meta.get("generation", 0))
            with self._lock:
                stale = self._channels.get(actor_id)
                self._channels[actor_id] = ch
            if stale is not None:
                stale.close()
            self.record(actor_id, generation, "connected")
            if self.on_connect is not None:
                self.on_connect(ch)
            while not done:
                before = ch.bytes_received
                kind, meta, payload = ch.recv()
                meta = dict(meta)
                meta["_wire_bytes"] = ch.bytes_received - before
                meta["_generation"] = generation
                done = kind == DONE_KIND
                self._q.put((kind, actor_id, meta, payload))
            # retired at ``done``: the publisher stops sending to a finished actor, and the
            # close gives its drain loop a prompt end of stream
        except (ChannelClosed, FramingError, TimeoutError):
            pass
        finally:
            eof_t = time.monotonic()
            if actor_id is not None:
                with self._lock:
                    if self._channels.get(actor_id) is ch:
                        del self._channels[actor_id]
            with self._lock:
                self._bytes_drained += ch.bytes_received
            ch.close()
            # the end of this generation's stream, also where a respawn replaced the channel
            # before this reader saw it end
            if actor_id is not None and not done and not self._stop.is_set():
                self._q.put(("closed", actor_id, {"generation": generation, "_eof_t": eof_t}, None))

    def close(self) -> None:
        self._stop.set()
        self._listener.close()
        for ch in self.channels():
            ch.close()


# ------------------------------------------------------------------- utilities
class _StatsCollector:
    """Stands in for the aggregator in ``record_episode_stats``: an actor ships its
    episode statistics in its blocks' meta instead of logging them."""

    def __init__(self) -> None:
        self.pairs: List[List[Any]] = []

    def update(self, name: str, value: Any) -> None:
        self.pairs.append([name, float(value)])

    def drain(self) -> List[List[Any]]:
        pairs, self.pairs = self.pairs, []
        return pairs


def _stamp_of(meta: Dict[str, Any]) -> Dict[str, Any]:
    """The consumer's stamp: ``{seq, grad_step, policy_step}`` and the publisher's
    ``t_pub``, which rides in the message's meta beside it."""
    stamp = dict(meta.get("stamp") or {})
    if meta.get("t_pub") is not None:
        stamp["t_pub"] = float(meta["t_pub"])
    return stamp


def _freshest(latest: Optional[Tuple[Any, Dict[str, Any]]], candidate: Tuple[Any, Dict[str, Any]]) -> Tuple[Any, Dict[str, Any]]:
    """The highest seq wins, not the last to arrive: the publisher's sends hold no lock,
    so a welcome can overtake a newer publication on the wire."""
    if latest is None or int(candidate[1].get("seq", 0)) >= int(latest[1].get("seq", 0)):
        return candidate
    return latest


def _pickup_params(ch, latest: Optional[Tuple[Any, Dict[str, Any]]]):
    """Read every pending publication and keep the freshest (an actor may skip
    publications, never act on parameters older than the latest)."""
    while ch.poll(0):
        kind, meta, payload = ch.recv()
        if kind == PARAMS_KIND:
            latest = _freshest(latest, (payload, _stamp_of(meta)))
    return latest


def _await_params(ch, last_seq: int, timeout_s: float):
    """PPO's lockstep: wait for a publication newer than ``last_seq``, then read on to
    the freshest (one publication per block keeps this one to one with the thread
    player's wait)."""
    deadline = time.monotonic() + timeout_s
    latest: Optional[Tuple[Any, Dict[str, Any]]] = None
    while latest is None or int(latest[1].get("seq", 0)) <= last_seq:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(f"no param publish newer than seq={last_seq} within {timeout_s}s")
        kind, meta, payload = ch.recv(timeout=remaining)
        if kind == PARAMS_KIND:
            latest = _freshest(latest, (payload, _stamp_of(meta)))
    return _pickup_params(ch, latest)


class _ReadAhead:
    """An actor's receiving side: a thread of its own reads the channel as messages
    arrive, and ``poll``/``recv`` read what it queued, as ``Channel``'s read the socket.
    An actor that read only between its sends could hang the pair once a message
    outgrows the sockets' buffers: the learner waiting to send it a publication while it
    waits to send the learner a block, whose reader waits for the learner to take the
    blocks queued before it. ``wait_closed`` waits for the learner to close the channel
    (after the actor's ``done``), so that every block sent reaches it."""

    def __init__(self, ch: Channel):
        self._ch = ch
        self._items: Deque[Any] = collections.deque()
        self._cond = threading.Condition()
        self._end = threading.Event()
        threading.Thread(target=self._read, name="sebulba-actor-read", daemon=True).start()

    def _read(self) -> None:
        while True:
            try:
                item = self._ch.recv()
            except (ChannelClosed, FramingError, OSError) as exc:
                item = ChannelClosed(str(exc))
            with self._cond:
                self._items.append(item)
                self._cond.notify_all()
            if isinstance(item, ChannelClosed):
                self._end.set()
                return

    def poll(self, timeout: float = 0.0) -> bool:
        with self._cond:
            return self._cond.wait_for(lambda: self._items, timeout)

    def recv(self, timeout: Optional[float] = None) -> Tuple[str, Dict[str, Any], Any]:
        with self._cond:
            if not self._cond.wait_for(lambda: self._items, timeout):
                raise TimeoutError(f"no message within {timeout}s")
            if isinstance(self._items[0], ChannelClosed):
                raise self._items[0]  # the end stays queued
            return self._items.popleft()

    def wait_closed(self, timeout_s: float) -> None:
        self._end.wait(timeout_s)


#: set once a summary reached the disk in this process, so that ``run``'s fallback for a
#: crash before the loop never overwrites the loop's own
_summary_written = False


def _write_summary(summary: Dict[str, Any]) -> None:
    global _summary_written
    path = os.environ.get(SUMMARY_ENV_VAR)
    if not path:
        return
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(summary, f)
    os.replace(tmp, path)
    _summary_written = True


def _exc_summary(exc: BaseException) -> Dict[str, Any]:
    return {"type": type(exc).__name__, "message": str(exc)[:2000]}


class _SlotAccounting:
    """A global env-step count that never goes back across actor generations: each slot
    reports its own cumulative steps, and a closed slot's latest count folds into a base
    offset; its respawn counts again from zero. Counts are kept per (slot, generation),
    so a closed generation whose end the learner takes after its respawn's first blocks
    folds its own count only."""

    def __init__(self) -> None:
        self._latest: Dict[Tuple[int, int], int] = {}
        self._offset = 0

    def report(self, actor_id: int, env_steps: int, generation: int = 0) -> None:
        key = (actor_id, generation)
        self._latest[key] = max(self._latest.get(key, 0), int(env_steps))

    def fold(self, actor_id: int, generation: int = 0) -> None:
        self._offset += self._latest.pop((actor_id, generation), 0)

    @property
    def total(self) -> int:
        return self._offset + sum(self._latest.values())


def _process_stats(device: torch.device) -> Dict[str, Any]:
    """This process's kernel launch counts and peak device memory (None on the CPU)."""
    from sheeprl_tpu_torch.ops.counters import launch_counts

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {"launches": launch_counts(), "peak_bytes": peak}


def _actor_generator(cfg, spec: PlacementSpec, device: torch.device) -> torch.Generator:
    """The actor's draws: the thread player's seed (``algos/decoupled.py``) plus its id."""
    from sheeprl_tpu_torch.algos.decoupled import PLAYER_SEED_OFFSET

    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg.seed) + PLAYER_SEED_OFFSET + spec.actor_id)
    return gen


@torch.no_grad()
def _adopt(own: Dict[str, torch.Tensor], arrays: Dict[str, np.ndarray]) -> None:
    """Copy a publication into the actor's own tensors, by name (never rebinding one)."""
    for name, t in own.items():
        t.copy_(torch.from_numpy(np.asarray(arrays[name])))


# ------------------------------------------------------------------ SAC: actor
def _run_sac_actor(ctx, cfg, spec: PlacementSpec) -> None:
    from sheeprl_tpu_torch.algos.sac.agent import build_agent
    from sheeprl_tpu_torch.algos.sac.sac import sample_tanh
    from sheeprl_tpu_torch.algos.sac.utils import env_actions, vector_rows
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.fault import chaos
    from sheeprl_tpu_torch.utils.env import make_vector_env
    from sheeprl_tpu_torch.utils.logger import get_log_dir
    from sheeprl_tpu_torch.utils.metric import record_episode_stats
    from sheeprl_tpu_torch.utils.utils import Ratio

    device = ctx.device
    actor_id = spec.actor_id
    log_dir = get_log_dir(cfg)
    shard_pool_cfg(cfg, spec.num_actors, actor_id)
    tracer = _actor_observability(cfg, spec, log_dir, "sac")
    envs = make_vector_env(cfg, cfg.seed, actor_id, log_dir if cfg.env.capture_video else None)
    ch = None
    try:
        obs_space, act_space = envs.single_observation_space, envs.single_action_space
        mlp_keys = list(cfg.algo.mlp_keys.encoder)
        low, high = act_space.low, act_space.high
        rescale = np.isfinite(low).all() and np.isfinite(high).all()
        # the same seed builds the learner's initial parameters; publications replace them
        actor = build_agent(ctx, act_space, obs_space, cfg).actor.requires_grad_(False)
        own = dict(actor.state_dict())

        num_envs, num_actors = int(cfg.env.num_envs), spec.num_actors
        rb = ReplayBuffer(
            max(int(cfg.buffer.size) // max(num_envs * num_actors, 1), 1),
            num_envs,
            obs_keys=("obs",),
            memmap=cfg.buffer.memmap,
            memmap_dir=os.path.join(log_dir, "memmap_buffer", f"rank_{actor_id}") if cfg.buffer.memmap else None,
        )
        rb.seed(cfg.seed + actor_id)
        ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
        batch_size = int(cfg.algo.per_rank_batch_size)
        stats = _StatsCollector()
        gen = _actor_generator(cfg, spec, device)

        # num_actors plays the part of the thread path's one player in every count
        policy_steps_per_iter = num_envs * num_actors
        num_iters = max(int(cfg.algo.total_steps) // policy_steps_per_iter, 1) if not cfg.dry_run else 1
        learning_starts = int(cfg.algo.learning_starts) // policy_steps_per_iter if not cfg.dry_run else 0
        prefill_iters = max(learning_starts - 1, 0)

        ch = connect(spec.host, spec.port, spec.connect_timeout_s)
        inbox = _ReadAhead(ch)
        ch.send(HELLO_KIND, None, actor_id=actor_id, generation=spec.generation, algo="sac")
        latest: Optional[Tuple[Any, Dict[str, Any]]] = None
        stamp: Dict[str, Any] = {}
        policy_step = 0
        obs, _ = envs.reset(seed=cfg.seed + actor_id)
        for iter_num in range(1, num_iters + 1):
            chaos.maybe_actor_fault(actor_id, spec.generation, iter_num)
            picked = _pickup_params(inbox, latest)
            if picked is not latest and picked is not None:
                latest = picked
                _adopt(own, picked[0]["actor"])
                stamp = picked[1]
            env_t0 = time.perf_counter()
            if iter_num <= learning_starts:
                actions = np.stack([act_space.sample() for _ in range(num_envs)])
                tanh_actions = 2 * (actions - low) / (high - low) - 1 if rescale else actions
            else:
                rows = torch.from_numpy(vector_rows(obs, mlp_keys)).to(device)
                tanh_actions = sample_tanh(actor, rows, gen).float().cpu().numpy()
                actions = env_actions(tanh_actions, act_space)
            next_obs, reward, terminated, truncated, info = envs.step(actions)
            done = np.logical_or(terminated, truncated)
            real_next = {k: np.asarray(v).copy() for k, v in next_obs.items()}
            if done.any() and "final_obs" in info:
                for i in np.nonzero(done)[0]:
                    if info["final_obs"][i] is not None:
                        for k in real_next:
                            real_next[k][i] = np.asarray(info["final_obs"][i][k])
            rb.add({
                "obs": vector_rows(obs, mlp_keys)[None],
                "next_obs": vector_rows(real_next, mlp_keys)[None],
                "actions": np.asarray(tanh_actions, np.float32).reshape(1, num_envs, -1),
                "rewards": np.asarray(reward, np.float32).reshape(1, num_envs, 1),
                # a truncated episode still bootstraps: dones is the termination
                "dones": np.asarray(terminated, np.float32).reshape(1, num_envs, 1),
            }, validate_args=cfg.buffer.validate_args)
            obs = next_obs
            policy_step += policy_steps_per_iter
            record_episode_stats(stats, info)
            env_time = time.perf_counter() - env_t0

            grad_steps, batches = 0, None
            if iter_num >= learning_starts:
                grad_steps = max(ratio((policy_step - prefill_iters * policy_steps_per_iter) / num_actors), 0)
                if grad_steps > 0:
                    batches = rb.sample(batch_size, n_samples=grad_steps)
            ch.send(BLOCK_KIND, {"batches": batches}, iter_num=iter_num, grad_steps=grad_steps, policy_step=policy_step,
                    env_time=env_time, env_steps=iter_num * num_envs, staleness=staleness_steps(stamp, policy_step),
                    stats=stats.drain())
        ch.send(DONE_KIND, None, env_steps=num_iters * num_envs, rollout=rollout_metrics(envs), **_process_stats(device))
        inbox.wait_closed(spec.connect_timeout_s)
    finally:
        _actor_obs_teardown(tracer, log_dir)
        if ch is not None:
            ch.close()
        envs.close()


# ---------------------------------------------------------------- SAC: learner
def _run_sac_learner(ctx, cfg, spec: PlacementSpec):
    from sheeprl_tpu_torch.algos.dreamer_loop import load_opt_states
    from sheeprl_tpu_torch.algos.sac.agent import action_dim
    from sheeprl_tpu_torch.algos.sac.sac import sac_parts
    from sheeprl_tpu_torch.algos.sac.utils import AGGREGATOR_KEYS
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.data.buffers import to_device
    from sheeprl_tpu_torch.data.device_buffer import make_host_dispatcher

    monitor = _learner_monitor(ctx, cfg)  # before the step is built: its capture and cost model count
    obs_space, act_space = _probe_spaces(cfg)
    parts = sac_parts(ctx, cfg, obs_space, act_space)
    agent, opt_states = parts.agent, parts.opt_states
    if cfg.checkpoint.get("resume_from"):  # parameters and optimizer state; the actors refill their shards
        state = CheckpointManager.load(cfg.checkpoint.resume_from)
        agent.load_state_dict(state["params"])
        load_opt_states(opt_states, state["opt_state"])
    specs = {"obs": parts.obs_spec, "next_obs": parts.obs_spec, "actions": ((action_dim(act_space),), np.float32),
             "rewards": ((1,), np.float32), "dones": ((1,), np.float32)}
    dispatcher = make_host_dispatcher(ctx, cfg, specs, parts.make_step, parts.target_update_freq, parts.count_offset)
    device = ctx.device

    def train_block(meta, payload, cumulative_grad_steps):
        grad_steps = int(meta["grad_steps"])
        if grad_steps <= 0 or payload.get("batches") is None:
            return 0, 0.0
        maybe_digest(f"sac:{int(meta['iter_num'])}", payload["batches"])
        t0 = time.perf_counter()
        dispatcher.dispatch(to_device(payload["batches"], device), cumulative_grad_steps)
        return grad_steps, time.perf_counter() - t0

    def publish(publisher, cumulative_grad_steps, policy_step):
        # the actors only act: the actor alone goes on the wire
        publisher.publish({"actor": dict(agent.actor.state_dict())}, grad_step=cumulative_grad_steps, policy_step=policy_step)

    def save_state(policy_step, cumulative_grad_steps, blocks):
        return {"params": agent.state_dict(), "opt_state": opt_states, "iter_num": blocks, "policy_step": policy_step,
                "cumulative_grad_steps": cumulative_grad_steps}

    aggregator = _learner_aggregator(cfg, AGGREGATOR_KEYS)

    def log_metrics():
        dispatcher.drain(aggregator)
        sps = dispatcher.pop_window_sps()
        return {} if sps is None else {"Time/sps_train": sps}

    return _learner_loop(ctx, cfg, spec, aggregator, monitor, train_block=train_block, publish=publish, save_state=save_state,
                         log_metrics=log_metrics, sps_env_steps=int(cfg.env.num_envs))


# ------------------------------------------------------------------ PPO: actor
def _ppo_num_updates(cfg, spec: PlacementSpec) -> int:
    policy_steps_per_iter = int(cfg.env.num_envs * cfg.algo.rollout_steps * spec.num_actors)
    return max(int(cfg.algo.total_steps) // policy_steps_per_iter, 1) if not cfg.dry_run else 1


def _run_ppo_actor(ctx, cfg, spec: PlacementSpec) -> None:
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import PPOActing, PPOTrainFns
    from sheeprl_tpu_torch.fault import chaos
    from sheeprl_tpu_torch.utils.env import make_vector_env
    from sheeprl_tpu_torch.utils.logger import get_log_dir
    from sheeprl_tpu_torch.utils.metric import record_episode_stats

    device = ctx.device
    actor_id = spec.actor_id
    log_dir = get_log_dir(cfg)
    shard_pool_cfg(cfg, spec.num_actors, actor_id)
    tracer = _actor_observability(cfg, spec, log_dir, "ppo")
    envs = make_vector_env(cfg, cfg.seed, actor_id, log_dir if cfg.env.capture_video else None)
    ch = None
    try:
        obs_space, act_space = envs.single_observation_space, envs.single_action_space
        obs_keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
        agent = build_agent(ctx, act_space, obs_space, cfg)
        own = dict(agent.state_dict())
        num_envs, rollout_steps, num_actors = int(cfg.env.num_envs), int(cfg.algo.rollout_steps), spec.num_actors
        num_updates = _ppo_num_updates(cfg, spec)
        # the actor's part of the train functions: acting, values and GAE (no update)
        fns = PPOTrainFns(ctx, agent, cfg, obs_keys, num_updates)
        acting = PPOActing(cfg, fns, envs, _actor_generator(cfg, spec, device))
        stats = _StatsCollector()

        ch = connect(spec.host, spec.port, spec.connect_timeout_s)
        inbox = _ReadAhead(ch)
        ch.send(HELLO_KIND, None, actor_id=actor_id, generation=spec.generation, algo="ppo")
        stamp: Dict[str, Any] = {}
        last_seq, policy_step = 0, 0

        def on_step(info):
            nonlocal policy_step
            policy_step += num_envs * num_actors
            record_episode_stats(stats, info)

        obs, _ = envs.reset(seed=cfg.seed + actor_id)
        for update in range(1, num_updates + 1):
            chaos.maybe_actor_fault(actor_id, spec.generation, update)
            env_t0 = time.perf_counter()
            obs = acting.collect(obs, on_step)
            env_time = time.perf_counter() - env_t0
            data = host_arrays(acting.batch(obs))
            ch.send(BLOCK_KIND, {"data": data}, update=update, policy_step=policy_step, env_time=env_time,
                    env_steps=update * rollout_steps * num_envs, staleness=staleness_steps(stamp, policy_step), stats=stats.drain())
            # the lockstep: the publication of the update this batch feeds, before acting again
            payload, stamp = _await_params(inbox, last_seq, spec.connect_timeout_s)
            last_seq = int(stamp.get("seq", last_seq + 1))
            _adopt(own, payload)
        ch.send(DONE_KIND, None, env_steps=num_updates * rollout_steps * num_envs, rollout=rollout_metrics(envs), **_process_stats(device))
        inbox.wait_closed(spec.connect_timeout_s)
    finally:
        _actor_obs_teardown(tracer, log_dir)
        if ch is not None:
            ch.close()
        envs.close()


# ---------------------------------------------------------------- PPO: learner
def _run_ppo_learner(ctx, cfg, spec: PlacementSpec):
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import Optimizer, PPOTrainFns, annealed_coefs
    from sheeprl_tpu_torch.algos.ppo.utils import AGGREGATOR_KEYS
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.data.buffers import to_device

    monitor = _learner_monitor(ctx, cfg)
    obs_space, act_space = _probe_spaces(cfg)
    obs_keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
    agent = build_agent(ctx, act_space, obs_space, cfg)
    num_updates = _ppo_num_updates(cfg, spec)
    fns = PPOTrainFns(ctx, agent, cfg, obs_keys, num_updates, cost_name="ppo_sebulba/train_fn")
    if cfg.checkpoint.get("resume_from"):  # parameters and optimizer state, as the reference's learner
        state = CheckpointManager.load(cfg.checkpoint.resume_from)
        agent.load_state_dict(state["params"])
        Optimizer.load_state(fns.opt_state, state["opt_state"])
    train_gen = ctx.rng()  # drawn where the thread path draws it: the same permutations
    device = ctx.device
    aggregator = _learner_aggregator(cfg, AGGREGATOR_KEYS)

    def train_block(meta, payload, cumulative_grad_steps):
        update = int(meta["update"])
        maybe_digest(f"ppo:{update}", payload["data"])
        t0 = time.perf_counter()
        metrics = fns.train_fn(to_device(payload["data"], device), fns.permutations(train_gen), *annealed_coefs(cfg, update, num_updates))
        for k, v in metrics.items():
            aggregator.update(k, v)
        return fns.grad_steps_per_update, time.perf_counter() - t0

    def publish(publisher, cumulative_grad_steps, policy_step):
        publisher.publish(dict(agent.state_dict()), grad_step=cumulative_grad_steps, policy_step=policy_step)

    def save_state(policy_step, cumulative_grad_steps, blocks):
        return {"params": agent.state_dict(), "opt_state": fns.opt_state, "update": blocks, "policy_step": policy_step}

    return _learner_loop(ctx, cfg, spec, aggregator, monitor, train_block=train_block, publish=publish, save_state=save_state,
                         sps_env_steps=int(cfg.env.num_envs * cfg.algo.rollout_steps), publish_empty_blocks=True)


# -------------------------------------------------------------- learner kernel
def _learner_monitor(ctx, cfg):
    """The learner's training monitor (``obs/monitor.py``): its log dir is the run's."""
    from sheeprl_tpu_torch.obs import TrainingMonitor
    from sheeprl_tpu_torch.utils.logger import get_log_dir

    return TrainingMonitor(cfg, get_log_dir(cfg), device=ctx.device, phases=())  # the reference's learner times no phase


def _actor_observability(cfg, spec: PlacementSpec, log_dir: str, algo: str):
    """An actor's share of the observability plane: a flight recorder (its dump goes to
    the actor's log dir when it crashes) and, with ``obs.enabled``, a span tracer whose
    Chrome trace the actor writes as ``trace_rank<actor_id + 1>.json`` when it ends.
    Returns the tracer or None."""
    from sheeprl_tpu_torch.obs import flight_recorder, tracer as obs_tracer

    obs_cfg = dict(cfg.get("obs") or {})
    if bool(obs_cfg.get("flight_recorder", True)) and flight_recorder.get_active() is None:
        flight_recorder.install(flight_recorder.FlightRecorder(
            log_dir=log_dir,
            capacity=int(obs_cfg.get("flight_recorder_capacity", 4096)),
            keep_events=int(obs_cfg.get("flight_recorder_keep_events", 512)),
            algo=f"{algo}_sebulba_actor",
            cfg=cfg,
        ))
    if not (bool(obs_cfg.get("enabled", False)) and bool(obs_cfg.get("trace", True))):
        return None
    tracer = obs_tracer.SpanTracer(rank=spec.actor_id + 1, max_events=int(obs_cfg.get("max_events", 100_000)))
    obs_tracer.set_active(tracer)
    return tracer


def _actor_obs_teardown(tracer, log_dir: str) -> None:
    """Write the actor's trace and deactivate its tracer; never raises."""
    from sheeprl_tpu_torch.obs import tracer as obs_tracer

    if tracer is None:
        return
    try:
        os.makedirs(log_dir, exist_ok=True)
        tracer.export_chrome_trace(os.path.join(log_dir, f"trace_rank{tracer.rank}.json"))
    except OSError:
        pass
    if obs_tracer.get_active() is tracer:
        obs_tracer.set_active(None)


def _learner_aggregator(cfg, aggregator_keys):
    from sheeprl_tpu_torch.utils.metric import make_aggregator

    aggregator = make_aggregator(cfg.metric.aggregator.get("metrics", {}), disabled=cfg.metric.get("log_level", 1) == 0)
    aggregator.keep(set(aggregator_keys) | SEBULBA_METRIC_KEYS | set(cfg.metric.aggregator.get("metrics", {})))
    return aggregator


def _learner_loop(
    ctx,
    cfg,
    spec: PlacementSpec,
    aggregator,
    monitor,
    *,
    train_block: Callable[[Dict[str, Any], Any, int], Tuple[int, float]],
    publish: Callable[[ChannelWeightPublisher, int, int], None],
    save_state: Callable[[int, int, int], Dict[str, Any]],
    sps_env_steps: int,
    publish_empty_blocks: bool = False,
    log_metrics: Optional[Callable[[], Dict[str, float]]] = None,
):
    """The learner's algorithm-free body: the inbox, the publications, the metrics, the
    checkpoint cadence, the lifecycle accounting, the preemption boundary and the exit
    summary. ``train_block(meta, payload, cumulative_grad_steps) -> (grad_steps,
    seconds)`` runs the update; ``publish`` publishes the parameters (after every block
    with gradient steps, or after every block with ``publish_empty_blocks``, which keeps
    PPO's lockstep going); ``log_metrics()`` drains deferred metrics into ``aggregator``
    at the log cadence and returns extra ones; ``save_state`` is the checkpoint's tree.
    Returns the run's ``TrainResult``."""
    from sheeprl_tpu_torch.algos.loop_common import TrainResult
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.config.core import save_config
    from sheeprl_tpu_torch.fault.guard import TrainingGuard
    from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger

    log_dir = get_log_dir(cfg)
    save_config(cfg, Path(log_dir) / "config.yaml")
    logger = get_logger(cfg, log_dir)
    ckpt_manager = CheckpointManager(Path(log_dir) / "checkpoints", keep_last=cfg.checkpoint.keep_last)
    guard = TrainingGuard(cfg, log_dir)
    device = ctx.device

    listener = Listener(spec.host, spec.port)
    publisher = ChannelWeightPublisher(lambda: inbox.channels())
    inbox = LearnerInbox(listener, spec, on_connect=publisher.maybe_welcome)

    t_start = time.monotonic()
    done_slots: set = set()
    slots = _SlotAccounting()
    cumulative_grad_steps = blocks = policy_step = last_log = last_checkpoint = 0
    last_path: Optional[str] = None
    train_seconds = env_seconds = 0.0
    last_progress = time.monotonic()
    #: [monotonic t, cumulative_grad_steps] per consumed block: the liveness trace
    grad_trace: List[List[float]] = []
    staleness: List[float] = []
    actor_stats: Dict[str, Any] = {}
    idle_timeout_s = max(float(spec.connect_timeout_s) * 5.0, 60.0)

    def save_ckpt():
        nonlocal last_checkpoint, last_path
        last_path = str(ckpt_manager.save(policy_step, save_state(policy_step, cumulative_grad_steps, blocks)))
        last_checkpoint = policy_step
        return last_path

    def boundary():
        # the training guard: a forwarded SIGTERM ends the learner with a checkpoint, the
        # PREEMPTED marker and Preempted, which the train entry turns into exit 75
        guard.boundary(policy_step, save_ckpt)

    error: Optional[Dict[str, Any]] = None
    try:
        while len(done_slots) < spec.num_actors:
            try:
                kind, actor_id, meta, payload = inbox.get(timeout=1.0)
            except queue.Empty:
                boundary()
                if time.monotonic() - last_progress > idle_timeout_s:
                    raise RuntimeError(
                        f"sebulba learner starved: no actor message for {idle_timeout_s:.0f}s "
                        f"({len(done_slots)}/{spec.num_actors} actors done)"
                    )
                continue
            last_progress = time.monotonic()
            if kind == DONE_KIND:
                done_slots.add(actor_id)
                slots.report(actor_id, int(meta.get("env_steps", 0)), int(meta.get("_generation", 0)))
                inbox.record(actor_id, int(meta.get("_generation", 0)), "done")
                actor_stats[f"{actor_id}_g{int(meta.get('_generation', 0))}"] = {
                    k: meta.get(k) for k in ("env_steps", "launches", "peak_bytes", "rollout")}
                continue
            if kind == "closed":
                if actor_id not in done_slots:
                    slots.fold(actor_id, int(meta["generation"]))
                boundary()
                continue
            if kind == ABANDON_KIND:
                # the launcher spent this slot's respawns: stop waiting for it (its env
                # steps stay folded from the close)
                done_slots.add(actor_id)
                inbox.record(actor_id, -1, "abandoned")
                continue
            if kind != BLOCK_KIND:
                continue

            monitor.advance()
            blocks += 1
            policy_step = max(policy_step, int(meta.get("policy_step", 0)))
            slots.report(actor_id, int(meta.get("env_steps", 0)), int(meta.get("_generation", 0)))
            with monitor.phase("dispatch"):
                grad_steps, train_time = train_block(meta, payload, cumulative_grad_steps)
            cumulative_grad_steps += grad_steps
            train_seconds += train_time
            env_time = float(meta.get("env_time", 0) or 0)
            env_seconds += env_time
            grad_trace.append([time.monotonic(), cumulative_grad_steps])
            if grad_steps > 0 or publish_empty_blocks:
                publish(publisher, cumulative_grad_steps, policy_step)

            for name, value in meta.get("stats") or []:
                aggregator.update(name, value)
            aggregator.update("Sebulba/queue_depth", inbox.qsize())
            if meta.get("staleness") is not None:
                staleness.append(float(meta["staleness"]))
                aggregator.update("Sebulba/param_staleness_steps", float(meta["staleness"]))
            aggregator.update("Sebulba/xfer_bytes", float(meta.get("_wire_bytes", 0)))
            aggregator.update(f"Sebulba/xfer_bytes/ch{actor_id}", float(meta.get("_wire_bytes", 0)))

            if logger is not None and (policy_step - last_log >= cfg.metric.log_every or cfg.dry_run):
                extra = log_metrics() if log_metrics is not None else {}
                metrics = aggregator.compute()
                aggregator.reset()
                if train_time > 0:
                    metrics["Time/sps_train"] = grad_steps / train_time
                if env_time > 0:
                    metrics["Time/sps_env_interaction"] = sps_env_steps / env_time
                metrics.update(extra)
                monitor.log_metrics(logger, metrics, policy_step)
                last_log = policy_step

            if cfg.checkpoint.every > 0 and (policy_step - last_checkpoint) >= cfg.checkpoint.every:
                save_ckpt()
            boundary()

        if cfg.checkpoint.save_last:
            save_ckpt()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    except BaseException as exc:
        # a learner that ends on an error still leaves its summary behind
        error = _exc_summary(exc)
        raise
    finally:
        monitor.close()
        bytes_received = inbox.bytes_received()
        inbox.close()
        n_pub = max(publisher.seq, 1)
        _write_summary({
            "wall_time_s": time.monotonic() - t_start,
            "blocks": blocks,
            "cumulative_grad_steps": cumulative_grad_steps,
            "env_steps_total": slots.total,
            "policy_step": policy_step,
            "bytes_received": bytes_received,
            "bytes_published": publisher.bytes_published,
            "publishes": publisher.seq,
            "publish_ms": {"host": 1e3 * publisher.host_seconds / n_pub, "send": 1e3 * publisher.send_seconds / n_pub},
            "staleness_steps": {"mean": float(np.mean(staleness)) if staleness else None,
                                "max": max(staleness) if staleness else None, "n": len(staleness)},
            "grad_step_trace": grad_trace,
            "events": inbox.events,
            "t_start": t_start,
            "learner": _process_stats(device),
            "actors": actor_stats,
            "checkpoint": last_path,
            "error": error,
        })
        if logger is not None:
            logger.close()
    return TrainResult(log_dir, policy_step, cumulative_grad_steps, last_path, time.monotonic() - t_start, train_seconds, env_seconds, None)


def _probe_spaces(cfg):
    """The learner steps no env: one env built as the actors' env 0 gives the spaces the
    agent is built from (so its parameters are the actors' bit for bit)."""
    from sheeprl_tpu_torch.utils.env import make_env

    probe = make_env(cfg, cfg.seed, 0)()
    obs_space, act_space = probe.observation_space, probe.action_space
    probe.close()
    return obs_space, act_space


# ----------------------------------------------------------------------- entry
_RUNNERS = {
    ("sac", "learner"): _run_sac_learner,
    ("sac", "actor"): _run_sac_actor,
    ("ppo", "learner"): _run_ppo_learner,
    ("ppo", "actor"): _run_ppo_actor,
}


def run(ctx, cfg, spec: PlacementSpec, algo: str):
    """A Sebulba child's role (the decoupled entries call it with
    ``distributed.mode=sebulba``): the learner returns its ``TrainResult``, an actor
    None."""
    from sheeprl_tpu_torch.fault import chaos

    key = (algo, spec.role)
    if key not in _RUNNERS:
        raise ValueError(f"no sebulba runner for algo={algo!r} role={spec.role!r}")
    chaos.install(cfg)
    try:
        return _RUNNERS[key](ctx, cfg, spec)
    except BaseException as exc:
        # a learner that fails before its loop (the agent's build, the resume, the space
        # probe) leaves a summary with the error all the same
        if spec.is_learner and not _summary_written:
            _write_summary({
                "wall_time_s": 0.0, "blocks": 0, "cumulative_grad_steps": 0, "env_steps_total": 0, "policy_step": 0,
                "bytes_received": 0, "bytes_published": 0, "publishes": 0, "grad_step_trace": [], "events": [],
                "t_start": time.monotonic(), "error": _exc_summary(exc),
            })
        raise
