"""Batched continuous Mountain Car (counterpart of
``sheeprl_tpu/envs/jax/mountain_car.py``), the dynamics of gymnasium's
``MountainCarContinuous-v0``: a +100 reward at the goal minus a quadratic action cost,
the ``TimeLimit(999)`` in the state. A reset draws ``position ~ U(-0.6, -0.4)`` with zero
velocity."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.batched.core import BatchedEnv, time_limit


class MountainCarParams(NamedTuple):
    min_position: float = -1.2
    max_position: float = 0.6
    max_speed: float = 0.07
    goal_position: float = 0.45
    goal_velocity: float = 0.0
    power: float = 0.0015
    max_episode_steps: int = 999


class MountainCarState(NamedTuple):
    position: torch.Tensor
    velocity: torch.Tensor
    time: torch.Tensor


class MountainCarContinuous(BatchedEnv):
    name = "mountain_car_continuous"

    def default_params(self) -> MountainCarParams:
        return MountainCarParams()

    def reset_bounds(self, params: MountainCarParams):
        return [-0.6], [-0.4]

    def reset(self, params: MountainCarParams, draws: torch.Tensor) -> Tuple[MountainCarState, torch.Tensor]:
        position = draws[..., 0]
        state = MountainCarState(position, torch.zeros_like(position), torch.zeros(position.shape, dtype=torch.int32, device=draws.device))
        return state, self._obs(state)

    @staticmethod
    def _obs(state: MountainCarState) -> torch.Tensor:
        return torch.stack([state.position, state.velocity], -1)

    def step(self, params: MountainCarParams, state: MountainCarState, action: torch.Tensor):
        force = torch.clamp(action[..., 0].float(), -1.0, 1.0)
        velocity = state.velocity + force * params.power - 0.0025 * torch.cos(3 * state.position)
        velocity = torch.clamp(velocity, -params.max_speed, params.max_speed)
        position = torch.clamp(state.position + velocity, params.min_position, params.max_position)
        # hitting the left wall kills leftward velocity (gymnasium's inelastic stop)
        velocity = torch.where((position == params.min_position) & (velocity < 0), 0.0, velocity)
        new_state = MountainCarState(position, velocity, state.time + 1)
        terminated = (position >= params.goal_position) & (velocity >= params.goal_velocity)
        truncated, done = time_limit(params, new_state.time, terminated)
        reward = torch.where(terminated, 100.0, 0.0) - 0.1 * (force * force)
        return new_state, self._obs(new_state), reward, done, {"terminated": terminated, "truncated": truncated}

    def observation_space(self, params: MountainCarParams) -> spaces.Box:
        low = np.array([params.min_position, -params.max_speed], dtype=np.float32)
        high = np.array([params.max_position, params.max_speed], dtype=np.float32)
        return spaces.Box(low, high, dtype=np.float32)

    def action_space(self, params: MountainCarParams) -> spaces.Box:
        return spaces.Box(-1.0, 1.0, (1,), np.float32)
