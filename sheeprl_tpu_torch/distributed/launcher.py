"""The Sebulba launcher (counterpart of ``sheeprl_tpu/distributed/launcher.py``):
``python -m sheeprl_tpu_torch.sebulba <overrides>``.

It places one learner and ``distributed.num_actors`` actor processes, each an ordinary
``python -m sheeprl_tpu_torch`` run with its role stamped on as overrides (so every
child composes its config, refuses what the port lacks and resolves its device as any
run does; a ``device=`` override reaches every child), and watches them:

* **the learner** is the run: when it exits, the launcher exits with its code and is
  never respawned;
* **an actor** that dies (the chaos kill, an out-of-memory error, an env crash) is
  respawned after a bounded backoff (``distributed.respawn_backoff_s``,
  ``distributed.max_actor_respawns``) with a bumped ``SHEEPRL_TPU_ACTOR_GENERATION``;
  it reconnects, gets the freshest parameters as a welcome and refills its replay
  shard. An actor that exits 0 is done;
* a slot whose respawns are spent is **abandoned**: the launcher connects to the
  learner's listener and sends ``abandon``, so the learner stops waiting for it.

SIGTERM and SIGINT are forwarded to the children; on the way out every child still
running is terminated, then killed. The children stay in the launcher's process group,
so a caller that kills the group ends them all. The learner logs under the run's
``run_name``, actor ``i`` under ``<run_name>_actor<i>`` and its respawns under
``<run_name>_actor<i>_g<generation>``. The launcher itself composes the config and opens
one socket: it never initialises CUDA. Not ported: the reference's fleet telemetry
plane (its aggregator and crash bundles).
"""

from __future__ import annotations

import datetime
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from sheeprl_tpu_torch.distributed.placement import (
    GENERATION_ENV_VAR,
    ROLE_ACTOR,
    ROLE_LEARNER,
    SUMMARY_ENV_VAR,
    PlacementSpec,
    placement_from_cfg,
)
from sheeprl_tpu_torch.distributed.transport import Listener, connect
from sheeprl_tpu_torch.fault.supervisor import _strip_override, backoff_seconds

#: the overrides the launcher owns: it stamps its own on every child
LAUNCHER_KEYS = ("distributed.role", "distributed.port", "distributed.actor_id", "run_name")


def _log(msg: str) -> None:
    print(f"[sebulba] {msg}", flush=True)


def _base_overrides(overrides: List[str]) -> List[str]:
    """The overrides without the launcher-owned keys."""
    for key in LAUNCHER_KEYS:
        overrides, _ = _strip_override(overrides, key)
        overrides, _ = _strip_override(overrides, f"+{key}")
    return overrides


def _spawn(overrides: List[str], child_ovs: List[str], run_name: str, env: Dict[str, str], what: str) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "sheeprl_tpu_torch", *overrides, *child_ovs, f"run_name={run_name}"]
    _log(f"spawning {what}: {' '.join(cmd[3:])}")
    return subprocess.Popen(cmd, env=env)


def _abandon(spec: PlacementSpec, port: int, actor_id: int) -> None:
    try:
        ch = connect(spec.host, port, timeout_s=5.0)
        ch.send("abandon", None, actor_id=actor_id)
        ch.close()
    except (ConnectionError, OSError) as e:
        _log(f"could not notify learner of abandoned actor {actor_id}: {e}")


def launch(args: Optional[List[str]] = None) -> int:
    """Compose the placement, spawn the learner and the actors, watch them; returns the
    learner's exit code."""
    from sheeprl_tpu_torch.config.core import compose

    overrides = _base_overrides(list(args if args is not None else sys.argv[1:]))
    if not any(ov.lstrip("+").startswith("distributed.mode=") for ov in overrides):
        overrides.append("distributed.mode=sebulba")
    cfg = compose(overrides=overrides)
    spec = placement_from_cfg(cfg)
    run_name = cfg.get("run_name")
    if not run_name:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        run_name = f"{stamp}_{cfg.get('exp_name', 'run')}_{cfg.get('seed', 0)}_sebulba"

    # reserve the rendezvous port (port=0: a free one) and release it before the learner
    # binds it: the children get the number as an override
    port = spec.port
    if port == 0:
        probe = Listener(spec.host, 0)
        port = probe.port
        probe.close()

    def child_env(role: str, generation: int = 0) -> Dict[str, str]:
        env = dict(os.environ)
        env.pop(SUMMARY_ENV_VAR, None)  # the summary is the learner's
        if role == ROLE_LEARNER and os.environ.get(SUMMARY_ENV_VAR):
            env[SUMMARY_ENV_VAR] = os.environ[SUMMARY_ENV_VAR]
        env[GENERATION_ENV_VAR] = str(generation)
        return env

    learner = _spawn(overrides, spec.child_overrides(ROLE_LEARNER, port), run_name, child_env(ROLE_LEARNER), "learner")
    actors: Dict[int, Optional[subprocess.Popen]] = {}
    generations = {i: 0 for i in range(spec.num_actors)}
    respawns = {i: 0 for i in range(spec.num_actors)}
    respawn_at: Dict[int, float] = {}
    for i in range(spec.num_actors):
        actors[i] = _spawn(overrides, spec.child_overrides(ROLE_ACTOR, port, actor_id=i), f"{run_name}_actor{i}",
                           child_env(ROLE_ACTOR), f"actor{i}")

    def children() -> List[subprocess.Popen]:
        return [p for p in (learner, *actors.values()) if p is not None]

    terminating = False

    def forward(signum, frame):  # pragma: no cover - signal timing
        nonlocal terminating
        terminating = True
        for p in children():
            if p.poll() is None:
                p.send_signal(signum)

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, forward)
        except ValueError:  # not the main thread
            pass

    try:
        while True:
            rc = learner.poll()
            if rc is not None:
                _log(f"learner exited rc={rc}")
                return rc
            now = time.monotonic()
            for i, proc in list(actors.items()):
                if proc is not None and proc.poll() is not None:
                    arc = proc.returncode
                    actors[i] = None
                    if arc == 0:
                        _log(f"actor{i} done")
                        continue
                    if terminating or not spec.respawn:
                        _log(f"actor{i} died rc={arc}; not respawning")
                        continue
                    respawns[i] += 1
                    if respawns[i] > spec.max_actor_respawns:
                        _log(f"actor{i} died rc={arc}; respawn budget ({spec.max_actor_respawns}) exhausted, abandoning slot")
                        _abandon(spec, port, i)
                        continue
                    delay = backoff_seconds(respawns[i], spec.respawn_backoff_s, 30.0)
                    _log(f"actor{i} died rc={arc}; respawn {respawns[i]}/{spec.max_actor_respawns} in {delay:.1f}s")
                    respawn_at[i] = now + delay
                elif proc is None and i in respawn_at and now >= respawn_at[i]:
                    del respawn_at[i]
                    generations[i] += 1
                    actors[i] = _spawn(overrides, spec.child_overrides(ROLE_ACTOR, port, actor_id=i),
                                       f"{run_name}_actor{i}_g{generations[i]}", child_env(ROLE_ACTOR, generations[i]),
                                       f"actor{i}(gen{generations[i]})")
            time.sleep(0.05)
    finally:
        for p in children():
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + 10.0
        for p in children():
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)


def main(args: Optional[List[str]] = None) -> None:
    sys.exit(launch(args))
