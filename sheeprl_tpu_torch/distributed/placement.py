"""Placement spec: which Sebulba role this process plays, and where its peers are
(counterpart of ``sheeprl_tpu/distributed/placement.py``, standard library only).

Sebulba is a placement of processes: one learner, ``distributed.num_actors`` actors that
own env shards, and framed channels between them (``transport.py``). The launcher
(``launcher.py``) composes the placement from the ``distributed`` config group and stamps
each child with its role and actor id as overrides; a process started by hand may set
the ``SHEEPRL_TPU_SEBULBA_*`` environment variables instead, which win over the config.

The generation counter rides an environment variable rather than the config: it changes
on every respawn, and keeping it out of the config keeps a child's config the same
across respawns.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

ROLE_LAUNCHER = "launcher"
ROLE_LEARNER = "learner"
ROLE_ACTOR = "actor"
_ROLES = (ROLE_LAUNCHER, ROLE_LEARNER, ROLE_ACTOR)

_PUBLISH_MODES = ("auto", "device", "host")

#: the launcher sets GENERATION on respawned actors; all of them let a process started
#: by hand join a placement without editing its config
ROLE_ENV_VAR = "SHEEPRL_TPU_SEBULBA_ROLE"
ACTOR_ID_ENV_VAR = "SHEEPRL_TPU_SEBULBA_ACTOR_ID"
HOST_ENV_VAR = "SHEEPRL_TPU_SEBULBA_HOST"
PORT_ENV_VAR = "SHEEPRL_TPU_SEBULBA_PORT"
GENERATION_ENV_VAR = "SHEEPRL_TPU_ACTOR_GENERATION"

#: where the learner writes its exit summary (JSON: counts, the gradient-step trace, the
#: channels' lifecycle events), when set
SUMMARY_ENV_VAR = "SHEEPRL_TPU_SEBULBA_SUMMARY"


def _dist_cfg(cfg: Any) -> Dict[str, Any]:
    try:
        section = cfg.get("distributed") if hasattr(cfg, "get") else getattr(cfg, "distributed", None)
    except Exception:
        section = None
    return dict(section) if section else {}


@dataclass(frozen=True)
class PlacementSpec:
    """One process's view of the Sebulba placement."""

    mode: str = "thread"
    role: str = ROLE_LAUNCHER
    num_actors: int = 1
    host: str = "127.0.0.1"
    port: int = 0
    actor_id: int = 0
    generation: int = 0
    connect_timeout_s: float = 60.0
    publish: str = "auto"
    queue_depth: int = 2
    respawn: bool = True
    respawn_backoff_s: float = 0.5
    max_actor_respawns: int = 3

    def __post_init__(self) -> None:
        if self.role not in _ROLES:
            raise ValueError(f"distributed.role must be one of {_ROLES}; got {self.role!r}")
        if self.publish not in _PUBLISH_MODES:
            raise ValueError(f"distributed.publish must be one of {_PUBLISH_MODES}; got {self.publish!r}")
        if self.num_actors < 1:
            raise ValueError(f"distributed.num_actors must be >= 1; got {self.num_actors}")
        if not (0 <= self.actor_id < self.num_actors):
            raise ValueError(
                f"distributed.actor_id={self.actor_id} out of range for num_actors={self.num_actors}"
            )
        if self.queue_depth < 1:
            raise ValueError(f"distributed.queue_depth must be >= 1; got {self.queue_depth}")

    @property
    def is_sebulba(self) -> bool:
        return self.mode == "sebulba"

    @property
    def is_learner(self) -> bool:
        return self.role == ROLE_LEARNER

    @property
    def is_actor(self) -> bool:
        return self.role == ROLE_ACTOR

    def child_overrides(self, role: str, port: int, actor_id: int = 0) -> list:
        """The overrides the launcher appends when it spawns this child role."""
        ovs = [
            "distributed.mode=sebulba",
            f"distributed.role={role}",
            f"distributed.port={port}",
            f"distributed.host={self.host}",
            f"distributed.num_actors={self.num_actors}",
        ]
        if role == ROLE_ACTOR:
            ovs.append(f"distributed.actor_id={actor_id}")
        return ovs


def placement_from_cfg(cfg: Any, env: Optional[Dict[str, str]] = None) -> PlacementSpec:
    """The spec from the ``distributed`` config group and the environment's overrides."""
    env = os.environ if env is None else env
    dist = _dist_cfg(cfg)

    def pick(env_var: str, key: str, default: Any, cast) -> Any:
        if env_var and env.get(env_var) not in (None, ""):
            return cast(env[env_var])
        value = dist.get(key, default)
        return default if value is None else cast(value)

    return PlacementSpec(
        mode=str(dist.get("mode", "thread") or "thread"),
        role=pick(ROLE_ENV_VAR, "role", ROLE_LAUNCHER, str),
        num_actors=pick("", "num_actors", 1, int),
        host=pick(HOST_ENV_VAR, "host", "127.0.0.1", str),
        port=pick(PORT_ENV_VAR, "port", 0, int),
        actor_id=pick(ACTOR_ID_ENV_VAR, "actor_id", 0, int),
        generation=int(env.get(GENERATION_ENV_VAR, 0) or 0),
        connect_timeout_s=pick("", "connect_timeout_s", 60.0, float),
        publish=str(dist.get("publish", "auto") or "auto"),
        queue_depth=pick("", "queue_depth", 2, int),
        respawn=bool(dist.get("respawn", True)),
        respawn_backoff_s=pick("", "respawn_backoff_s", 0.5, float),
        max_actor_respawns=pick("", "max_actor_respawns", 3, int),
    )
