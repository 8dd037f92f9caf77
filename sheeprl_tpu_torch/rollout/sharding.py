"""Shard a host's env-pool worker budget across Sebulba actor processes (counterpart of
``sheeprl_tpu/rollout/sharding.py``, standard library only).

A thread-decoupled run owns the whole host, so ``env.pool.num_workers`` (or its
cpu-count default) is a budget per host. Under Sebulba ``num_actors`` processes run that
config on one host, so each actor takes a disjoint ``1/num_actors`` slice of the budget,
the remainder going to the lowest actor ids. An actor calls ``shard_pool_cfg`` before it
builds its vector env (``distributed/sebulba.py``), where the reference's does; it
changes nothing when the pool is off.
"""

from __future__ import annotations

import os
from typing import Any, Optional


def shard_worker_count(num_workers: Optional[int], num_actors: int, actor_id: int) -> Optional[int]:
    """This actor's slice (>= 1) of a host-wide worker budget; ``num_workers`` as it is
    for a single actor."""
    if num_actors <= 1:
        return num_workers
    if not (0 <= actor_id < num_actors):
        raise ValueError(f"actor_id {actor_id} out of range for num_actors {num_actors}")
    if num_workers is None:
        # the pool's default is min(num_envs, cpu_count): shard the cpu budget instead
        num_workers = max(os.cpu_count() or 1, 1)
    base, extra = divmod(int(num_workers), num_actors)
    return max(1, base + (1 if actor_id < extra else 0))


def shard_pool_cfg(cfg: Any, num_actors: int, actor_id: int) -> None:
    """Rewrite ``cfg.env.pool.num_workers`` in place to this actor's shard; nothing when
    the pool is off or the run has one actor."""
    pool_cfg = cfg.env.get("pool") or {}
    if not pool_cfg.get("enabled", False) or num_actors <= 1:
        return
    cfg.env.pool.num_workers = shard_worker_count(pool_cfg.get("num_workers"), num_actors, actor_id)
