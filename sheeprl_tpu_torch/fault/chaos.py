"""The chaos harness (counterpart of ``sheeprl_tpu/fault/chaos.py``): a seeded fault
schedule from the ``chaos`` config group, each fault pinned to a policy step so that a
chaos run is reproducible.

* ``chaos.kill_at_step=N``: deliver ``chaos.kill_signal`` (SIGTERM | SIGINT | SIGKILL) to
  this process at the first loop boundary at or past step N. SIGTERM drills the graceful
  path (boundary checkpoint, ``PREEMPTED`` marker, exit 75), SIGKILL the supervisor's
  crash path (no goodbye at all).
* ``chaos.corrupt_ckpt_at_step=N`` with ``chaos.corrupt_mode=bitflip|truncate``: damage
  the newest published checkpoint (a seeded byte of its largest ``.pt`` entry), so that a
  resume must fall back to the checkpoint before it.
* ``chaos.delay_at_step=N`` with ``chaos.delay_ms``: stall one loop boundary.
* ``chaos.worker_fault_at_step=N`` with ``chaos.worker_fault_mode=crash|hang`` and
  ``chaos.worker_index=i``: env-pool worker ``i`` crashes (``os._exit`` with
  :data:`WORKER_CRASH_EXIT_CODE`) or hangs (sleeps ``chaos.worker_hang_s``, past the step
  timeout) at its ``N``-th step command, to drill the pool's restarts
  (``rollout/worker.py`` polls :func:`maybe_worker_fault`); only generation 0 fires, so
  the replacement runs clean.
* ``chaos.kill_actor_at_step=N`` with ``chaos.kill_actor_index=i``: SIGKILL Sebulba
  actor process ``i`` at its ``N``-th iteration (``distributed/sebulba.py`` polls
  :func:`maybe_actor_fault`); only generation 0 fires, so the respawn runs clean.

The step faults are edge triggers: one fires when the step crosses its threshold, and a
run resumed past the threshold never fires it again: that is what makes kill at step N
with ``fault.autoresume=True`` end.

Deviations: the port's checkpoint entries are ``<name>.pt`` files, so the corruption
targets the largest ``.pt`` (the reference's its largest ``.msgpack``, else its largest
file). The reference's worker-fault spec reaches a pool worker through ``fork``; the
port's workers are spawned, so the pool reads the spec (:func:`worker_fault_spec`) and
hands it to each worker as an argument, which installs it (:func:`install_worker_fault`)
before its first step. Standard library only: the pool's workers import this module.
"""

from __future__ import annotations

import os
import signal
import time
import warnings
from pathlib import Path
from typing import Any, Dict, Optional

from sheeprl_tpu_torch.fault import counters as _counters
from sheeprl_tpu_torch.fault import preemption

_KILL_SIGNALS = {"SIGTERM": signal.SIGTERM, "SIGINT": signal.SIGINT, "SIGKILL": signal.SIGKILL}
_CORRUPT_MODES = ("bitflip", "truncate")
_WORKER_MODES = ("crash", "hang")

#: the exit code of an env-pool worker that the chaos schedule crashed
WORKER_CRASH_EXIT_CODE = 117

# the actor-kill spec, parsed by ``install`` from this process's own config
_actor_fault: Optional[Dict[str, Any]] = None
# the env-pool worker fault: parsed by ``install`` in the training process, handed to each
# pool worker as an argument and installed there by ``install_worker_fault``
_worker_fault: Optional[Dict[str, Any]] = None


def _record(kind: str, **payload: Any) -> None:
    recorder = preemption.flight_recorder()
    if recorder is not None:
        recorder.record_event(kind, **payload)


def _chaos_cfg(cfg: Any) -> Dict[str, Any]:
    try:
        chaos = cfg.get("chaos") if hasattr(cfg, "get") else getattr(cfg, "chaos", None)
    except Exception:
        return {}
    return dict(chaos) if chaos else {}


def install(cfg: Any) -> None:
    """Parse the process-level part of the schedule (the actor kill, the pool worker's
    fault) into module state and validate the grammar of the rest loudly
    (``cli.run_algorithm`` calls it before every run, a Sebulba child before its loop)."""
    global _actor_fault, _worker_fault
    chaos = _chaos_cfg(cfg)
    _actor_fault = None
    _worker_fault = None
    if not chaos:
        return
    if chaos.get("kill_actor_at_step") is not None:
        _actor_fault = {"at_step": int(chaos["kill_actor_at_step"]), "actor": int(chaos.get("kill_actor_index", 0) or 0)}
    sig_name = str(chaos.get("kill_signal", "SIGTERM")).upper()
    if chaos.get("kill_at_step") is not None and sig_name not in _KILL_SIGNALS:
        raise ValueError(f"chaos.kill_signal must be one of {sorted(_KILL_SIGNALS)}; got {sig_name!r}")
    mode = str(chaos.get("corrupt_mode", "bitflip"))
    if chaos.get("corrupt_ckpt_at_step") is not None and mode not in _CORRUPT_MODES:
        raise ValueError(f"chaos.corrupt_mode must be one of {_CORRUPT_MODES}; got {mode!r}")
    if chaos.get("worker_fault_at_step") is not None:
        wmode = str(chaos.get("worker_fault_mode", "crash"))
        if wmode not in _WORKER_MODES:
            raise ValueError(f"chaos.worker_fault_mode must be one of {_WORKER_MODES}; got {wmode!r}")
        _worker_fault = {
            "at_step": int(chaos["worker_fault_at_step"]),
            "mode": wmode,
            "worker": int(chaos.get("worker_index", 0) or 0),
            "hang_s": float(chaos.get("worker_hang_s", 3600.0)),
        }


def worker_fault_spec() -> Optional[Dict[str, Any]]:
    """The installed worker-fault spec (None without one), for the pool to hand over."""
    return None if _worker_fault is None else dict(_worker_fault)


def install_worker_fault(spec: Optional[Dict[str, Any]]) -> None:
    """Install a worker-fault spec handed to a pool worker (``rollout/worker.py``)."""
    global _worker_fault
    _worker_fault = None if spec is None else dict(spec)


def maybe_worker_fault(worker_idx: int, generation: int, step_count: int) -> None:
    """Polled by the pool's worker once per step command: worker ``worker_idx`` of
    generation 0 crashes or hangs at its ``at_step``-th step. The event goes to this
    process's flight recorder where it has one (a spawned worker has none: the parent
    records the crash or the timeout as ``rollout_crash`` or ``rollout_timeout``)."""
    spec = _worker_fault
    if spec is None or generation != 0 or worker_idx != spec["worker"]:
        return
    if step_count == spec["at_step"]:
        _record("chaos_worker_fault", step=step_count, worker=worker_idx, mode=spec["mode"])
        if spec["mode"] == "crash":
            os._exit(WORKER_CRASH_EXIT_CODE)
        time.sleep(spec["hang_s"])  # hang: the parent's step timeout reaps this process


def maybe_actor_fault(actor_id: int, generation: int, step_count: int) -> None:
    """Polled by the Sebulba actor loop once per iteration. SIGKILL, with no goodbye and
    no flushed buffers: what is under test is the learner's liveness and the launcher's
    respawn (a generation above 0 never fires, so the experiment ends)."""
    spec = _actor_fault
    if spec is None or generation != 0 or actor_id != spec["actor"]:
        return
    if step_count >= spec["at_step"]:
        _record("chaos_actor_kill", step=step_count, actor_id=actor_id)
        os.kill(os.getpid(), signal.SIGKILL)


class ChaosMonkey:
    """The boundary's fault injector; inert (one attribute check) without a schedule.
    ``fire(step)`` is called once per training-loop boundary by ``TrainingGuard`` with the
    current policy step."""

    def __init__(self, cfg: Any, ckpt_dir: Optional[os.PathLike] = None, resumed: Optional[bool] = None):
        chaos = _chaos_cfg(cfg)
        self.seed = int(chaos.get("seed", 0) or 0)
        self.kill_at_step = chaos.get("kill_at_step")
        self.kill_signal = str(chaos.get("kill_signal", "SIGTERM")).upper()
        self.corrupt_at_step = chaos.get("corrupt_ckpt_at_step")
        self.corrupt_mode = str(chaos.get("corrupt_mode", "bitflip"))
        self.delay_at_step = chaos.get("delay_at_step")
        self.delay_ms = float(chaos.get("delay_ms", 500) or 0)
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir is not None else None
        if resumed is None:
            try:
                resumed = bool(cfg.get("checkpoint", {}).get("resume_from"))
            except Exception:
                resumed = False
        self.resumed = bool(resumed)
        self.enabled = any(v is not None for v in (self.kill_at_step, self.corrupt_at_step, self.delay_at_step))
        self._last_step: Optional[int] = None
        self._fired: set = set()

    def _crossed(self, kind: str, at_step: Optional[Any], step: int) -> bool:
        """Edge trigger: True exactly once, when ``step`` first reaches ``at_step`` within
        this run. A resumed run whose first boundary is already past the threshold crossed
        it in an earlier life: marked fired, never fired again."""
        if at_step is None or kind in self._fired:
            return False
        if self._last_step is None and self.resumed and step >= int(at_step):
            self._fired.add(kind)
            return False
        if step >= int(at_step):
            self._fired.add(kind)
            return True
        return False

    def fire(self, step: int) -> None:
        if not self.enabled:
            return
        step = int(step)
        if self._crossed("delay", self.delay_at_step, step):
            _record("chaos_delay", step=step, delay_ms=self.delay_ms)
            _counters.bump("Fault/chaos_injected")
            time.sleep(self.delay_ms / 1000.0)
        if self._crossed("corrupt", self.corrupt_at_step, step):
            _counters.bump("Fault/chaos_injected")
            self._corrupt_latest(step)
        if self._crossed("kill", self.kill_at_step, step):
            _record("chaos_kill", step=step, sig=self.kill_signal)
            _counters.bump("Fault/chaos_injected")
            self._kill()
        self._last_step = step

    def _kill(self) -> None:
        sig = _KILL_SIGNALS[self.kill_signal]
        os.kill(os.getpid(), sig)
        if sig != signal.SIGKILL:
            # the signal reaches the main thread asynchronously: wait for the sticky flag so
            # that this same boundary handles the preemption (what makes a kill reproducible)
            deadline = time.monotonic() + 5.0
            while not preemption.preemption_requested() and time.monotonic() < deadline:
                time.sleep(0.005)

    def _corrupt_latest(self, step: int) -> None:
        if self.ckpt_dir is None or not self.ckpt_dir.exists():
            warnings.warn(f"chaos.corrupt_ckpt_at_step={self.corrupt_at_step}: no checkpoint dir to corrupt")
            return
        ckpts = sorted((p for p in self.ckpt_dir.iterdir() if p.is_dir() and p.name.startswith("ckpt_")), key=lambda p: int(p.name.split("_")[1]))
        if not ckpts:
            warnings.warn(f"chaos.corrupt_ckpt_at_step={self.corrupt_at_step}: no published checkpoint yet")
            return
        target_dir = ckpts[-1]
        victims = sorted(target_dir.glob("*.pt"), key=lambda p: p.stat().st_size, reverse=True)
        if not victims:
            victims = sorted((p for p in target_dir.iterdir() if p.is_file()), key=lambda p: p.stat().st_size, reverse=True)
        if not victims:
            return
        corrupt_file(victims[0], mode=self.corrupt_mode, seed=self.seed)
        _record("chaos_corrupt", step=step, path=str(victims[0]), mode=self.corrupt_mode)


def corrupt_file(path: os.PathLike, mode: str = "bitflip", seed: int = 0) -> None:
    """Damage ``path`` reproducibly: flip the lowest bit of byte ``seed % size``, or cut
    the file to half its size."""
    path = Path(path)
    size = path.stat().st_size
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 0))
        return
    if size == 0:
        return
    offset = seed % size
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0x01]))
