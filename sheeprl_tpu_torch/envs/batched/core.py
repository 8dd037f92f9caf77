"""Batched environments on the device (counterpart of ``sheeprl_tpu/envs/jax/core.py``):
the env half of the Anakin engine (``engine/anakin.py``).

A :class:`BatchedEnv` expresses a whole environment as functions over a small state, a
NamedTuple of tensors with a leading env axis (and, for a population, a member axis
before it)::

    params = env.default_params()
    state, obs = env.reset(params, env.reset_draws(params, (n_envs,), generator))
    state, obs, reward, done, info = env.step(params, state, action)

``step`` works on the whole batch at once, where the reference vmaps one env; it never
branches in Python on a tensor's value, so a CUDA graph can capture it. Episode ends
surface as ``done``, and :meth:`BatchedEnv.step_autoreset` folds the reset in with
``torch.where``.

Draws: every random number an env uses (reset states, random actions) comes from an
explicit ``torch.Generator`` on the env's device, or is handed in (``draws``), so a test
feeds both packages the same samples. A reset's draws are the values the reference's
``jax.random.uniform`` returns, already scaled to their bounds.

``info`` holds ``terminated`` and ``truncated`` (SAC's TD target masks on the
termination only) and, from ``step_autoreset``, ``final_obs``: the finishing step's
observation before the reset. Spaces are the port's own (``envs/spaces.py``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces


class BatchedEnv:
    """Base class: subclasses implement ``default_params``, ``reset``, ``step``,
    ``reset_bounds`` and the two spaces."""

    name: str = "batched_env"

    def __init__(self):
        self._cache: Dict[Any, Tuple[torch.Tensor, ...]] = {}

    def default_params(self) -> NamedTuple:
        raise NotImplementedError

    def reset_bounds(self, params: NamedTuple) -> Tuple[Sequence[float], Sequence[float]]:
        """``(low, high)`` of the uniform draws one env's reset takes, one entry each."""
        raise NotImplementedError

    def reset(self, params: NamedTuple, draws: torch.Tensor) -> Tuple[NamedTuple, torch.Tensor]:
        """The state and observation of fresh episodes from ``[..., k]`` reset draws."""
        raise NotImplementedError

    def step(self, params: NamedTuple, state: NamedTuple, action: torch.Tensor) -> Tuple[NamedTuple, torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, Any]]:
        raise NotImplementedError

    def observation_space(self, params: NamedTuple) -> spaces.Box:
        raise NotImplementedError

    def action_space(self, params: NamedTuple) -> spaces.Space:
        raise NotImplementedError

    def _constants(self, key: Any, device: Any, make) -> Tuple[torch.Tensor, ...]:
        """Bound tensors on ``device``, made once: a captured step must not copy from the
        host."""
        key = (key, str(torch.device(device) if device is not None else "cpu"))
        if key not in self._cache:
            self._cache[key] = tuple(torch.as_tensor(np.asarray(b, np.float32), device=device) for b in make())
        return self._cache[key]

    def reset_draws(self, params: NamedTuple, batch: Sequence[int], generator: Optional[torch.Generator], device: Any = None) -> torch.Tensor:
        """``[*batch, k]`` uniform reset draws within ``reset_bounds`` from ``generator``."""
        low, high = self._constants(("reset", params), device, lambda: self.reset_bounds(params))
        u = torch.rand((*batch, low.shape[0]), generator=generator, device=device)
        return torch.maximum(low, u * (high - low) + low)

    def step_autoreset(
        self, params: NamedTuple, state: NamedTuple, action: torch.Tensor, generator: Optional[torch.Generator] = None,
        draws: Optional[torch.Tensor] = None,
    ) -> Tuple[NamedTuple, torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, Any]]:
        """Step with same-step auto-reset: where ``done``, the returned state and
        observation are a fresh episode's (from ``draws``, or drawn from ``generator``);
        the reward and ``info["final_obs"]`` still describe the finishing step. Both
        branches are computed and selected, as the reference's ``lax.select``."""
        stepped, obs_st, reward, done, info = self.step(params, state, action)
        if draws is None:
            draws = self.reset_draws(params, tuple(done.shape), generator, done.device)
        reset_state, reset_obs = self.reset(params, draws)
        state = type(stepped)(*(torch.where(done, r, s) for r, s in zip(reset_state, stepped)))
        obs = torch.where(done[..., None], reset_obs, obs_st)
        return state, obs, reward, done, {**info, "final_obs": obs_st}

    def sample_action(self, params: NamedTuple, batch: Sequence[int], generator: Optional[torch.Generator], device: Any = None) -> torch.Tensor:
        """Uniform random actions (``action_space.sample()`` for a batch): int32 for a
        discrete space, ``[*batch, *shape]`` float32 in a box's bounds."""
        space = self.action_space(params)
        if isinstance(space, spaces.Discrete):
            return torch.randint(0, int(space.n), tuple(batch), generator=generator, device=device, dtype=torch.int32)
        low, high = self._constants(("action", params), device, lambda: (space.low, space.high))
        u = torch.rand((*batch, *space.shape), generator=generator, device=device)
        return torch.maximum(low, u * (high - low) + low)


def time_limit(params: NamedTuple, time: torch.Tensor, terminated: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The in-graph ``TimeLimit``: ``(truncated, done)`` from the post-step ``time``
    counter. ``params.max_episode_steps <= 0`` disables it."""
    max_steps = int(params.max_episode_steps)
    if max_steps > 0:
        truncated = (time >= max_steps) & ~terminated
    else:
        truncated = torch.zeros_like(terminated)
    return truncated, terminated | truncated
