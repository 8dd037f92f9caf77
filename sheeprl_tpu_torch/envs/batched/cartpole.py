"""Batched CartPole (counterpart of ``sheeprl_tpu/envs/jax/cartpole.py``), the dynamics
of gymnasium's ``CartPole-v1``: its constants, euler integrator and termination
thresholds, with the ``TimeLimit(500)`` folded into ``params.max_episode_steps``. The
reward is 1.0 on every step, the terminating one included. A reset draws the 4-vector
uniformly from ``[-0.05, 0.05]``."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.batched.core import BatchedEnv, time_limit


class CartPoleParams(NamedTuple):
    gravity: float = 9.8
    masscart: float = 1.0
    masspole: float = 0.1
    length: float = 0.5  # half the pole's length
    force_mag: float = 10.0
    tau: float = 0.02
    theta_threshold: float = 12 * 2 * np.pi / 360
    x_threshold: float = 2.4
    reset_bound: float = 0.05
    max_episode_steps: int = 500


class CartPoleState(NamedTuple):
    x: torch.Tensor
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    time: torch.Tensor


class CartPole(BatchedEnv):
    name = "cartpole"

    def default_params(self) -> CartPoleParams:
        return CartPoleParams()

    def reset_bounds(self, params: CartPoleParams):
        return [-params.reset_bound] * 4, [params.reset_bound] * 4

    def reset(self, params: CartPoleParams, draws: torch.Tensor) -> Tuple[CartPoleState, torch.Tensor]:
        time = torch.zeros(draws.shape[:-1], dtype=torch.int32, device=draws.device)
        state = CartPoleState(draws[..., 0], draws[..., 1], draws[..., 2], draws[..., 3], time)
        return state, self._obs(state)

    @staticmethod
    def _obs(state: CartPoleState) -> torch.Tensor:
        return torch.stack([state.x, state.x_dot, state.theta, state.theta_dot], -1)

    def step(self, params: CartPoleParams, state: CartPoleState, action: torch.Tensor):
        total_mass = params.masspole + params.masscart
        polemass_length = params.masspole * params.length
        force = torch.where(action == 1, params.force_mag, -params.force_mag)
        costheta = torch.cos(state.theta)
        sintheta = torch.sin(state.theta)
        temp = (force + polemass_length * torch.square(state.theta_dot) * sintheta) / total_mass
        thetaacc = (params.gravity * sintheta - costheta * temp) / (
            params.length * (4.0 / 3.0 - params.masspole * torch.square(costheta) / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        # euler integrator (gymnasium's default kinematics_integrator)
        x = state.x + params.tau * state.x_dot
        x_dot = state.x_dot + params.tau * xacc
        theta = state.theta + params.tau * state.theta_dot
        theta_dot = state.theta_dot + params.tau * thetaacc
        new_state = CartPoleState(x, x_dot, theta, theta_dot, state.time + 1)
        terminated = (torch.abs(x) > params.x_threshold) | (torch.abs(theta) > params.theta_threshold)
        truncated, done = time_limit(params, new_state.time, terminated)
        reward = torch.ones_like(x)  # 1.0 every step, the terminating one included
        return new_state, self._obs(new_state), reward, done, {"terminated": terminated, "truncated": truncated}

    def observation_space(self, params: CartPoleParams) -> spaces.Box:
        fmax = np.finfo(np.float32).max
        high = np.array([params.x_threshold * 2, fmax, params.theta_threshold * 2, fmax], dtype=np.float32)
        return spaces.Box(-high, high, dtype=np.float32)

    def action_space(self, params: CartPoleParams) -> spaces.Discrete:
        return spaces.Discrete(2)
