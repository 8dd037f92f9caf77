"""The chaos harness's Sebulba half (counterpart of ``sheeprl_tpu/fault/chaos.py:
74-118``): ``chaos.kill_actor_at_step=N`` with ``chaos.kill_actor_index=i`` SIGKILLs
Sebulba actor process ``i`` at its ``N``-th iteration (``distributed/sebulba.py`` polls
``maybe_actor_fault`` once per iteration). The learner must keep taking gradient steps on
the other actors' blocks while the launcher respawns the victim; only generation 0
fires, so the respawn runs clean.

The schedule's other faults (``kill_at_step``, ``corrupt_ckpt_at_step``,
``delay_at_step``, ``worker_fault_at_step``) belong to the training guard and the env
pool, which the port does not have: every loop refuses them by name
(``algos/loop_common.py``). Standard library only.
"""

from __future__ import annotations

import os
import signal
from typing import Any, Dict, Optional

# the actor-kill spec, parsed by ``install`` from this process's own config
_actor_fault: Optional[Dict[str, Any]] = None


def _chaos_cfg(cfg: Any) -> Dict[str, Any]:
    try:
        chaos = cfg.get("chaos") if hasattr(cfg, "get") else getattr(cfg, "chaos", None)
    except Exception:
        return {}
    return dict(chaos) if chaos else {}


def install(cfg: Any) -> None:
    """Parse the actor-kill part of the schedule into module state (a Sebulba child calls
    it before its loop)."""
    global _actor_fault
    chaos = _chaos_cfg(cfg)
    _actor_fault = None
    if chaos.get("kill_actor_at_step") is not None:
        _actor_fault = {"at_step": int(chaos["kill_actor_at_step"]), "actor": int(chaos.get("kill_actor_index", 0) or 0)}


def maybe_actor_fault(actor_id: int, generation: int, step_count: int) -> None:
    """Polled by the Sebulba actor loop once per iteration. SIGKILL, with no goodbye and
    no flushed buffers: what is under test is the learner's liveness and the launcher's
    respawn (a generation above 0 never fires, so the experiment ends)."""
    spec = _actor_fault
    if spec is None or generation != 0 or actor_id != spec["actor"]:
        return
    if step_count >= spec["at_step"]:
        os.kill(os.getpid(), signal.SIGKILL)
