"""The env pool's worker process (counterpart of ``sheeprl_tpu/rollout/worker.py``).

Each worker owns one contiguous group of envs. Its duplex pipe speaks command/ack:

    ("reset", seeds, options) -> ("ok", [(env_idx, [info, ...]), ...])
    ("step",)                 -> ("ok", [(env_idx, [info, ...]), ...])
    ("close",)                -> ("ok", None)

Observations, rewards and the done flags never ride the pipe: the worker writes them
into its rows of the shared slabs (``shared.py``), and the ack carries the infos only:
none for an ordinary step; at an episode's end the ``{"final_obs", "final_info"}`` pair,
then the reset's info, the dicts the port's ``SyncVectorEnv`` adds to its batched info
in same-step autoreset, in the same order.

The worker is started with ``spawn`` and imports neither torch nor anything that does
(this module, ``shared.py``, the port's spaces and ``fault/chaos.py`` are numpy and the
standard library): it never touches the device. The chaos worker fault cannot ride a
fork into it, so the pool hands its spec over as an argument and the worker installs it
before its first step.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

InfoPayload = List[Tuple[int, List[dict]]]


def _start_heartbeat(heartbeats, worker_idx: int, interval_s: float) -> None:
    """A daemon thread stamping the wall-clock time: a stale stamp means the process died
    (a crash, the OOM killer, a kill); a hung env keeps beating and is caught by the
    parent's step timeout instead."""

    def beat() -> None:
        while True:
            heartbeats[worker_idx] = time.time()
            time.sleep(interval_s)

    threading.Thread(target=beat, name=f"envpool-heartbeat-{worker_idx}", daemon=True).start()


def worker_entry(
    worker_idx: int,
    first_env_idx: int,
    env_fns: Sequence[Callable[[], Any]],
    slabs,
    conn,
    heartbeat_interval_s: float,
    generation: int = 0,
    worker_fault: Optional[Dict[str, Any]] = None,
) -> None:
    from sheeprl_tpu_torch.fault import chaos

    chaos.install_worker_fault(worker_fault)
    envs: List[Any] = []
    step_count = 0
    try:
        views = slabs.views()
        _start_heartbeat(views.heartbeats, worker_idx, max(heartbeat_interval_s, 0.05))
        envs = [fn() for fn in env_fns]
        conn.send(("ready", None))
        while True:
            msg = conn.recv()
            cmd = msg[0]
            if cmd == "reset":
                _, seeds, options = msg
                payloads: InfoPayload = []
                for j, env in enumerate(envs):
                    gi = first_env_idx + j
                    obs, info = env.reset(seed=seeds[j], options=options)
                    views.write_obs(gi, obs)
                    views.rewards[gi] = 0.0
                    views.terminated[gi] = False
                    views.truncated[gi] = False
                    payloads.append((gi, [info] if info else []))
                conn.send(("ok", payloads))
            elif cmd == "step":
                step_count += 1
                chaos.maybe_worker_fault(worker_idx, generation, step_count)
                payloads = []
                for j, env in enumerate(envs):
                    gi = first_env_idx + j
                    obs, reward, terminated, truncated, info = env.step(views.read_action(gi))
                    entries: List[dict] = []
                    if terminated or truncated:
                        # same-step autoreset: the ending step's obs and info, then the reset's
                        entries.append({"final_obs": obs, "final_info": info})
                        obs, info = env.reset()
                    if info:
                        entries.append(info)
                    views.write_obs(gi, obs)
                    views.rewards[gi] = reward
                    views.terminated[gi] = bool(terminated)
                    views.truncated[gi] = bool(truncated)
                    payloads.append((gi, entries))
                conn.send(("ok", payloads))
            elif cmd == "close":
                for env in envs:
                    env.close()
                envs = []
                conn.send(("ok", None))
                return
            else:
                conn.send(("error", f"unknown command {cmd!r}"))
                return
    except (EOFError, KeyboardInterrupt):  # the parent went away
        return
    except Exception:
        try:
            conn.send(("error", traceback.format_exc()))
        except Exception:
            pass
    finally:
        for env in envs:
            try:
                env.close()
            except Exception:
                pass
        try:
            conn.close()
        except Exception:
            pass
