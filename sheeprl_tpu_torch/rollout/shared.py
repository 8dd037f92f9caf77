"""Preallocated shared-memory slabs of the env pool (counterpart of
``sheeprl_tpu/rollout/shared.py``).

One flat lock-free ``RawArray`` per batched leaf (each observation key, the float64
rewards, the bool ``terminated``/``truncated`` flags, the actions, the workers'
heartbeats), allocated once by the parent from the pool's multiprocessing context and
handed to every worker process at its creation (restarts too). Each step a worker writes
its group's rows in place and the parent reads them back: no observation or reward
crosses a pipe (only the infos of an episode's end do).

The layout is the one the port's ``SyncVectorEnv`` stacks (``envs/spaces.py::
create_empty_array``): a ``Dict`` space gives a dict of ``[num_envs, *shape]`` arrays, a
flat space one batched array, in the space's dtype. This module imports numpy and the
port's spaces only: it runs in the workers, which never import torch.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import numpy as np

from sheeprl_tpu_torch.envs.spaces import create_empty_array

SlabView = Union[np.ndarray, Dict[str, np.ndarray]]


def _alloc_raw(ctx, shape: Tuple[int, ...], dtype: np.dtype):
    """A ``RawArray`` (no lock: each worker owns a disjoint slice) of ``shape``'s bytes."""
    nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    return ctx.RawArray("b", max(nbytes, 1))


def _view(raw, shape: Tuple[int, ...], dtype: np.dtype) -> np.ndarray:
    return np.frombuffer(raw, dtype=dtype, count=int(np.prod(shape, dtype=np.int64))).reshape(shape)


class SharedSlab:
    """One space's batched shared buffer: the raw storage and its numpy view."""

    def __init__(self, ctx, space: Any, num_envs: int):
        template = create_empty_array(space, num_envs)
        if isinstance(template, dict):
            self._spec: Any = {k: (v.shape, v.dtype) for k, v in template.items()}
            self._raw: Any = {k: _alloc_raw(ctx, v.shape, v.dtype) for k, v in template.items()}
        else:
            self._spec = (template.shape, template.dtype)
            self._raw = _alloc_raw(ctx, template.shape, template.dtype)

    def view(self) -> SlabView:
        """The numpy view over the shared pages (each process builds its own)."""
        if isinstance(self._spec, dict):
            return {k: _view(self._raw[k], *self._spec[k]) for k in self._spec}
        return _view(self._raw, *self._spec)


class RolloutSlabs:
    """A pool's slabs, made in the parent before it starts a worker; each process calls
    ``views()`` for its numpy windows over the same pages."""

    def __init__(self, ctx, observation_space: Any, action_space: Any, num_envs: int, num_workers: int):
        self.obs = SharedSlab(ctx, observation_space, num_envs)
        self.actions = SharedSlab(ctx, action_space, num_envs)
        self._rewards = _alloc_raw(ctx, (num_envs,), np.float64)
        self._terminated = _alloc_raw(ctx, (num_envs,), np.bool_)
        self._truncated = _alloc_raw(ctx, (num_envs,), np.bool_)
        self._heartbeats = _alloc_raw(ctx, (num_workers,), np.float64)
        self._num_envs = num_envs
        self._num_workers = num_workers

    def views(self) -> "SlabViews":
        return SlabViews(
            obs=self.obs.view(),
            actions=self.actions.view(),
            rewards=_view(self._rewards, (self._num_envs,), np.float64),
            terminated=_view(self._terminated, (self._num_envs,), np.bool_),
            truncated=_view(self._truncated, (self._num_envs,), np.bool_),
            heartbeats=_view(self._heartbeats, (self._num_workers,), np.float64),
        )


class SlabViews:
    __slots__ = ("obs", "actions", "rewards", "terminated", "truncated", "heartbeats")

    def __init__(self, obs, actions, rewards, terminated, truncated, heartbeats):
        self.obs = obs
        self.actions = actions
        self.rewards = rewards
        self.terminated = terminated
        self.truncated = truncated
        self.heartbeats = heartbeats

    def write_obs(self, env_idx: int, obs: Any) -> None:
        if isinstance(self.obs, dict):
            for k, slab in self.obs.items():
                slab[env_idx] = np.asarray(obs[k])
        else:
            self.obs[env_idx] = np.asarray(obs)

    def read_obs_batch(self) -> SlabView:
        """A copy of the batched observation (callers keep observations across steps)."""
        if isinstance(self.obs, dict):
            return {k: v.copy() for k, v in self.obs.items()}
        return self.obs.copy()

    def read_action(self, env_idx: int) -> Any:
        """Env ``env_idx``'s action, its own copy (a row view would alias the slab)."""
        if isinstance(self.actions, dict):
            return {k: np.array(v[env_idx]) for k, v in self.actions.items()}
        act = self.actions[env_idx]
        return np.array(act) if isinstance(act, np.ndarray) else act

    def write_actions(self, actions: Any) -> None:
        if isinstance(self.actions, dict):
            for k, slab in self.actions.items():
                slab[:] = np.asarray(actions[k])
        else:
            self.actions[:] = np.asarray(actions).reshape(self.actions.shape)
