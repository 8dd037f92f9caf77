"""``EnvPool``: a shared-memory, multi-process, fault-tolerant vector env (counterpart of
``sheeprl_tpu/rollout/pool.py``), and ``rollout_metrics``.

One worker process per contiguous env group, the groups stepping at once, observations,
rewards and flags in shared memory (``shared.py``): a step costs the host a pipe ack and a
copy. Its semantics are the port's ``SyncVectorEnv``'s (``envs/vector.py``): the same
batched layout, float64 rewards, bool flags, ``final_obs``/``final_info`` merged through the
same ``VectorEnv._add_info`` in env order, and ``reset(seed=s)`` seeding env ``i`` with
``s + i``; the tests hold the two bit for bit, and the pool against the reference's.

Robustness:

* **step timeout**: a worker that does not ack within ``step_timeout_s`` (one deadline
  for all workers, from the dispatch) is declared hung, killed and restarted;
* **heartbeat**: each worker stamps a shared time from a daemon thread; a stale stamp
  shows a dead process (``heartbeat_ages``, ``Rollout/heartbeat_age_max``);
* **restart**: a replacement is started, its envs rebuilt and reset with the group's seeds
  plus ``7919 x generation``, and its envs report the break as ``truncated=True`` with
  ``info["rollout_restart"]``, so every loop's done path closes the episode;
* **budget**: past ``max_restarts`` restarts over the pool's life, the pool tears down and
  raises ``RolloutAbortError`` with a post-mortem of every worker.

Counters ``Rollout/*`` (``rollout_metrics``), spans ``Rollout/{step,step_wait,reset,
restart}`` and flight-recorder events ``rollout_{restart,timeout,crash,abort}`` as the
reference's.

Deviations: the workers start with ``spawn``, never ``fork`` (the reference's only
method): the training process holds a CUDA context and threads (the tracer, the
prefetcher, the watchdog, a Sebulba reader), and the port's env thunks pickle
(``utils/env.py::_EnvThunk``). A spawned worker re-imports the parent's main module (torch
with ``python -m sheeprl_tpu_torch``), so a worker's ready wait, at the first start and at
a restart, lasts ``max(step_timeout_s, START_TIMEOUT_S)`` (the reference waits
``step_timeout_s``, which a drill sets to a few seconds). The chaos worker fault reaches a
worker as an argument (``fault/chaos.py::worker_fault_spec``), not through ``fork``. A
crashed worker's message names its exit code. The pool implements same-step autoreset
only, as the port's vector envs do.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from sheeprl_tpu_torch.envs.spaces import batch_space
from sheeprl_tpu_torch.envs.vector import VectorEnv
from sheeprl_tpu_torch.fault import chaos
from sheeprl_tpu_torch.obs import flight_recorder
from sheeprl_tpu_torch.obs.tracer import span
from sheeprl_tpu_torch.rollout.shared import RolloutSlabs
from sheeprl_tpu_torch.rollout.worker import worker_entry


class RolloutAbortError(RuntimeError):
    """The worker-restart budget is spent: the env fleet keeps failing, and going on would
    feed training broken data."""


class _WorkerTimeout(Exception):
    pass


class _WorkerCrashed(Exception):
    pass


class _Worker:
    """The parent's handle of a worker: process, pipe, env range, restart generation."""

    __slots__ = ("idx", "first", "env_fns", "proc", "conn", "generation", "failed", "restarts", "timeouts", "crashes")

    def __init__(self, idx: int, first: int, env_fns: Sequence[Callable]):
        self.idx = idx
        self.first = first
        self.env_fns = list(env_fns)
        self.proc: Optional[Any] = None
        self.conn = None
        self.generation = 0
        self.failed = False
        # the worker's own fault ledger, quoted in the RolloutAbortError post-mortem
        self.restarts = 0
        self.timeouts = 0
        self.crashes = 0

    @property
    def num_envs(self) -> int:
        return len(self.env_fns)

    @property
    def env_indices(self) -> range:
        return range(self.first, self.first + len(self.env_fns))


# the reseed offset per restart generation (a prime, so that overlapping groups' seed
# ranges do not collide again after a restart)
_RESEED_STRIDE = 7919

#: the least deadline of a started worker's ready (a spawned worker imports the parent's
#: main module first: 5.7 s for one worker of ``chip_smoke.py`` on an H100 host)
START_TIMEOUT_S = 60.0


class EnvPool(VectorEnv):
    def __init__(
        self,
        env_fns: Sequence[Callable[[], Any]],
        num_workers: Optional[int] = None,
        step_timeout_s: float = 60.0,
        heartbeat_interval_s: float = 2.0,
        max_restarts: int = 3,
        restart_backoff_s: float = 0.5,
        start_method: Optional[str] = None,
        observation_space: Optional[Any] = None,
        action_space: Optional[Any] = None,
    ):
        if not env_fns:
            raise ValueError("EnvPool needs at least one env_fn")
        start_method = start_method or "spawn"
        if start_method != "spawn":
            raise ValueError(
                f"EnvPool start_method={start_method!r}: the pool starts its workers with 'spawn', never 'fork' (the "
                "training process holds a CUDA context and threads, which a forked child would inherit half-copied; the "
                "port's env thunks pickle, so spawn can ship them)"
            )
        self._ctx = mp.get_context(start_method)
        self.env_fns = list(env_fns)
        self.num_envs = len(self.env_fns)
        self.step_timeout_s = float(step_timeout_s)
        self.start_timeout_s = max(self.step_timeout_s, START_TIMEOUT_S)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.max_restarts = int(max_restarts)
        self.restart_backoff_s = float(restart_backoff_s)
        self.closed = True  # until the workers are up: close() is a no-op before

        if observation_space is None or action_space is None:
            # the spaces of one env built here, as AsyncVectorEnv's probe
            probe = self.env_fns[0]()
            observation_space = observation_space or probe.observation_space
            action_space = action_space or probe.action_space
            probe.close()
        self.single_observation_space = observation_space
        self.single_action_space = action_space
        self.observation_space = batch_space(observation_space, self.num_envs)
        self.action_space = batch_space(action_space, self.num_envs)

        if num_workers is None:
            num_workers = min(self.num_envs, max(os.cpu_count() or 1, 1))
        self.num_workers = max(1, min(int(num_workers), self.num_envs))

        # contiguous groups whose sizes differ by one at most
        base, extra = divmod(self.num_envs, self.num_workers)
        self._workers: List[_Worker] = []
        first = 0
        for w in range(self.num_workers):
            n = base + (1 if w < extra else 0)
            self._workers.append(_Worker(w, first, self.env_fns[first : first + n]))
            first += n

        # from the pool's own context: a spawned worker gets them as Process arguments
        self._slabs = RolloutSlabs(self._ctx, self.single_observation_space, self.single_action_space, self.num_envs, self.num_workers)
        self._views = self._slabs.views()
        self._env_seeds: List[Optional[int]] = [None] * self.num_envs
        self._reset_options: Optional[dict] = None
        self._step_pending = False
        self._worker_fault = chaos.worker_fault_spec()

        # Rollout/* counters (rollout_metrics)
        self._total_restarts = 0
        self._timeout_restarts = 0
        self._crash_restarts = 0
        self._step_count = 0

        self.closed = False
        try:
            for w in self._workers:
                self._spawn(w)  # raises where a thunk does not pickle (spawn ships it)
            for w in self._workers:
                try:
                    self._collect(w, self.start_timeout_s, expect="ready")
                except (_WorkerTimeout, _WorkerCrashed) as e:
                    raise RuntimeError(f"EnvPool worker {w.idx} failed to start: {e}") from e
        except BaseException:
            self.close(terminate=True)  # no worker outlives a pool that did not start
            raise

    # ------------------------------------------------------------------ processes
    def _spawn(self, w: _Worker) -> None:
        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        w.conn = parent_conn
        w.failed = False
        w.proc = self._ctx.Process(
            target=worker_entry,
            args=(w.idx, w.first, w.env_fns, self._slabs, child_conn, self.heartbeat_interval_s, w.generation, self._worker_fault),
            name=f"envpool-worker-{w.idx}-gen{w.generation}",
            daemon=True,
        )
        w.proc.start()
        child_conn.close()

    def _kill(self, w: _Worker) -> None:
        if w.proc is not None and w.proc.is_alive():
            w.proc.terminate()
            w.proc.join(timeout=2.0)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(timeout=2.0)
        if w.conn is not None:
            try:
                w.conn.close()
            except Exception:
                pass
        w.conn = None
        w.proc = None

    def _send(self, w: _Worker, msg: tuple) -> None:
        try:
            w.conn.send(msg)
        except (BrokenPipeError, OSError) as e:
            raise _WorkerCrashed(f"worker {w.idx} pipe broken on send: {e}")

    def _collect(self, w: _Worker, timeout_s: float, expect: str = "ok"):
        """Wait for a worker's ack, policing the deadline and the process's life."""
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise _WorkerTimeout(f"worker {w.idx} exceeded its {timeout_s:.1f}s deadline")
            if w.conn.poll(min(remaining, 0.2)):
                try:
                    msg = w.conn.recv()
                except (EOFError, OSError) as e:
                    # the process is ending: its exit code names the fault (117: the chaos crash)
                    if w.proc is not None:
                        w.proc.join(timeout=1.0)
                    code = None if w.proc is None else w.proc.exitcode
                    raise _WorkerCrashed(f"worker {w.idx} pipe closed ({e!r}; exitcode={code})")
                if msg[0] == "error":
                    raise _WorkerCrashed(f"worker {w.idx} raised:\n{msg[1]}")
                if msg[0] != expect:
                    raise _WorkerCrashed(f"worker {w.idx} protocol violation: got {msg[0]!r}, wanted {expect!r}")
                return msg[1]
            if w.proc is None or not w.proc.is_alive():
                if w.conn.poll(0):  # a last message sent before it died
                    continue
                code = None if w.proc is None else w.proc.exitcode
                raise _WorkerCrashed(f"worker {w.idx} died (exitcode={code})")

    def _abort_post_mortem(self) -> str:
        """Every worker's fault ledger, for the RolloutAbortError's message."""
        ages = self.heartbeat_ages()
        rows = []
        for w in self._workers:
            age = ages[w.idx] if w.idx < len(ages) else float("inf")
            age_s = f"{age:.1f}s" if np.isfinite(age) else "never"
            rows.append(f"worker {w.idx}: restarts={w.restarts} timeouts={w.timeouts} crashes={w.crashes} last_heartbeat={age_s} ago")
        return (
            f"totals: restarts={self._total_restarts} timeouts={self._timeout_restarts} "
            f"crashes={self._crash_restarts} over {self._step_count} steps; " + "; ".join(rows)
        )

    def heartbeat_ages(self) -> np.ndarray:
        """Seconds since each worker's last heartbeat (inf before its first)."""
        stamps = np.array(self._views.heartbeats, dtype=np.float64)
        return np.where(stamps > 0, time.time() - stamps, np.inf)

    # ------------------------------------------------------------------ restart
    def _worker_seeds(self, w: _Worker) -> List[Optional[int]]:
        offset = w.generation * _RESEED_STRIDE
        return [None if s is None else s + offset for s in (self._env_seeds[i] for i in w.env_indices)]

    def _restart(self, w: _Worker, reason: str) -> None:
        """Replace a failed worker; its envs come back reset with the generation's seeds.
        Raises ``RolloutAbortError`` past the budget."""
        with span("Rollout/restart"):
            while True:
                self._total_restarts += 1
                flight_recorder.record_event("rollout_restart", worker=w.idx, reason=reason, restart=self._total_restarts, budget=self.max_restarts)
                if self._total_restarts > self.max_restarts:
                    post_mortem = self._abort_post_mortem()
                    self.close(terminate=True)
                    flight_recorder.record_event("rollout_abort", worker=w.idx, reason=reason, restarts=self._total_restarts)
                    raise RolloutAbortError(
                        f"EnvPool exceeded max_restarts={self.max_restarts} (last failure: worker {w.idx}: {reason}); {post_mortem}"
                    )
                w.restarts += 1
                warnings.warn(f"EnvPool restarting worker {w.idx} ({reason}); restart {self._total_restarts}/{self.max_restarts}")
                self._kill(w)
                if self.restart_backoff_s > 0:
                    time.sleep(self.restart_backoff_s)
                w.generation += 1
                self._spawn(w)
                try:
                    self._collect(w, self.start_timeout_s, expect="ready")
                    self._send(w, ("reset", self._worker_seeds(w), self._reset_options))
                    self._collect(w, self.step_timeout_s)
                    w.failed = False
                    return
                except (_WorkerTimeout, _WorkerCrashed) as e:
                    reason = f"replacement failed: {e}"

    # ------------------------------------------------------------------ vector env
    def reset(self, *, seed=None, options: Optional[dict] = None):
        seeds = self._seeds(seed, self.num_envs)
        if len(seeds) != self.num_envs:
            raise ValueError(f"got {len(seeds)} seeds for {self.num_envs} envs")
        self._env_seeds = seeds
        self._reset_options = dict(options) if options else None
        self._step_pending = False
        with span("Rollout/reset"):
            for w in self._workers:
                try:
                    self._send(w, ("reset", self._worker_seeds(w), self._reset_options))
                except _WorkerCrashed as e:
                    w.failed = True
                    self._restart(w, str(e))  # the replacement resets its envs
            payloads = self._gather(command="reset")
        return self._views.read_obs_batch(), self._merge_infos(payloads)

    def step_async(self, actions) -> None:
        if self._step_pending:
            raise RuntimeError("step_async called with a step already pending")
        self._views.write_actions(actions)
        self._step_pending = True
        for w in self._workers:
            try:
                self._send(w, ("step",))
            except _WorkerCrashed:
                w.failed = True  # restarted in step_wait

    def step_wait(self):
        if not self._step_pending:
            raise RuntimeError("step_wait called without step_async")
        with span("Rollout/step_wait"):
            payloads = self._gather(command="step")
        self._step_pending = False
        self._step_count += 1
        infos = self._merge_infos(payloads)
        return (
            self._views.read_obs_batch(),
            np.array(self._views.rewards, dtype=np.float64),
            np.array(self._views.terminated, dtype=np.bool_),
            np.array(self._views.truncated, dtype=np.bool_),
            infos,
        )

    def step(self, actions):
        with span("Rollout/step"):
            self.step_async(actions)
            return self.step_wait()

    def _gather(self, command: str) -> Dict[int, List[dict]]:
        """Every worker's ack; a hung or crashed worker is restarted and its envs report a
        truncated boundary."""
        per_env: Dict[int, List[dict]] = {}
        # one deadline from the dispatch: the workers run at once, so each gets the whole
        # step budget, not what its turn in this loop leaves
        deadline = time.monotonic() + self.step_timeout_s
        for w in self._workers:
            failure: Optional[str] = None
            if w.failed:
                failure = "pipe broken at dispatch"
            else:
                try:
                    for gi, entries in self._collect(w, max(deadline - time.monotonic(), 0.01)):
                        per_env[gi] = entries
                    continue
                except _WorkerTimeout as e:
                    self._timeout_restarts += 1
                    w.timeouts += 1
                    failure = str(e)
                    flight_recorder.record_event("rollout_timeout", worker=w.idx, error=failure)
                except _WorkerCrashed as e:
                    self._crash_restarts += 1
                    w.crashes += 1
                    failure = str(e)
                    flight_recorder.record_event("rollout_crash", worker=w.idx, error=failure)
            self._restart(w, failure)
            # the replacement reset its envs and wrote their observations to the slab;
            # the break reads as a truncation (the RestartOnException convention)
            for gi in w.env_indices:
                self._views.rewards[gi] = 0.0
                self._views.terminated[gi] = False
                self._views.truncated[gi] = command == "step"
                per_env[gi] = [{"rollout_restart": True}]
        return per_env

    def _merge_infos(self, per_env: Dict[int, List[dict]]) -> dict:
        infos: dict = {}
        for gi in range(self.num_envs):
            for entry in per_env.get(gi, ()):
                infos = self._add_info(infos, entry, gi)
        return infos

    # ------------------------------------------------------------------ teardown
    def close(self, terminate: bool = False) -> None:
        if getattr(self, "closed", True):
            return
        self.closed = True
        for w in self._workers:
            if w.proc is None:
                continue
            if terminate or w.failed or not w.proc.is_alive():
                self._kill(w)
                continue
            try:
                # a pending step's ack may still be on its way: drain it first
                if self._step_pending and w.conn.poll(self.step_timeout_s):
                    w.conn.recv()
                self._send(w, ("close",))
                self._collect(w, timeout_s=5.0)
            except (_WorkerTimeout, _WorkerCrashed, EOFError, OSError):
                pass
            finally:
                self._kill(w)
        self._step_pending = False

    def __del__(self):
        try:
            self.close(terminate=True)
        except Exception:
            pass

    # ------------------------------------------------------------------ telemetry
    def rollout_metrics(self) -> Dict[str, float]:
        ages = self.heartbeat_ages()
        finite = ages[np.isfinite(ages)]
        return {
            "Rollout/worker_restarts": float(self._total_restarts),
            "Rollout/worker_timeouts": float(self._timeout_restarts),
            "Rollout/worker_crashes": float(self._crash_restarts),
            "Rollout/env_steps": float(self._step_count),
            "Rollout/num_workers": float(self.num_workers),
            "Rollout/heartbeat_age_max": float(finite.max()) if finite.size else 0.0,
        }


def rollout_metrics(envs: Any) -> Dict[str, float]:
    """``Rollout/*`` counters of a vector env that keeps them (the pool), ``{}`` otherwise,
    so that a loop merges them with one unconditional line."""
    fn = getattr(envs, "rollout_metrics", None)
    return fn() if callable(fn) else {}
