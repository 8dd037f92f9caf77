"""Batched Pendulum (counterpart of ``sheeprl_tpu/envs/jax/pendulum.py``), the dynamics of
gymnasium's ``Pendulum-v1``: continuous torque, dense reward, never terminates; an
episode ends only at the ``TimeLimit(200)``. A reset draws ``theta ~ U(-pi, pi)`` and
``theta_dot ~ U(-1, 1)``."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.batched.core import BatchedEnv, time_limit


class PendulumParams(NamedTuple):
    max_speed: float = 8.0
    max_torque: float = 2.0
    dt: float = 0.05
    g: float = 10.0
    m: float = 1.0
    l: float = 1.0  # noqa: E741
    max_episode_steps: int = 200


class PendulumState(NamedTuple):
    theta: torch.Tensor
    theta_dot: torch.Tensor
    time: torch.Tensor


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    """``((x + pi) % (2 pi)) - pi`` with the reference's float ``%``: the remainder of a
    truncated division (``fmod``, exact), moved into the divisor's sign. ``torch.remainder``
    computes ``a - b * floor(a / b)`` instead, which rounds differently."""
    period = 2 * np.pi
    r = torch.fmod(x + np.pi, period)
    r = torch.where((r != 0) & (r < 0), r + period, r)
    return r - np.pi


class Pendulum(BatchedEnv):
    name = "pendulum"

    def default_params(self) -> PendulumParams:
        return PendulumParams()

    def reset_bounds(self, params: PendulumParams):
        return [-np.pi, -1.0], [np.pi, 1.0]

    def reset(self, params: PendulumParams, draws: torch.Tensor) -> Tuple[PendulumState, torch.Tensor]:
        time = torch.zeros(draws.shape[:-1], dtype=torch.int32, device=draws.device)
        state = PendulumState(draws[..., 0], draws[..., 1], time)
        return state, self._obs(state)

    @staticmethod
    def _obs(state: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(state.theta), torch.sin(state.theta), state.theta_dot], -1)

    def step(self, params: PendulumParams, state: PendulumState, action: torch.Tensor):
        u = torch.clamp(action[..., 0].float(), -params.max_torque, params.max_torque)
        th = _angle_normalize(state.theta)
        costs = th * th + 0.1 * (state.theta_dot * state.theta_dot) + 0.001 * (u * u)
        newthdot = state.theta_dot + (
            3 * params.g / (2 * params.l) * torch.sin(state.theta) + 3.0 / (params.m * params.l**2) * u
        ) * params.dt
        newthdot = torch.clamp(newthdot, -params.max_speed, params.max_speed)
        newth = state.theta + newthdot * params.dt
        new_state = PendulumState(newth, newthdot, state.time + 1)
        terminated = torch.zeros_like(newth, dtype=torch.bool)
        truncated, done = time_limit(params, new_state.time, terminated)
        return new_state, self._obs(new_state), -costs, done, {"terminated": terminated, "truncated": truncated}

    def observation_space(self, params: PendulumParams) -> spaces.Box:
        high = np.array([1.0, 1.0, params.max_speed], dtype=np.float32)
        return spaces.Box(-high, high, dtype=np.float32)

    def action_space(self, params: PendulumParams) -> spaces.Box:
        return spaces.Box(-params.max_torque, params.max_torque, (1,), np.float32)
