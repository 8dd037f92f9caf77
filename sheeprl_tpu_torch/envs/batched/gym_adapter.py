"""One batched env stepped on the CPU through the port's env API (counterpart of
``sheeprl_tpu/envs/jax/gym_adapter.py``).

This is the compatibility path: it lets ``env=jax_cartpole`` run through the port's host
loops (their vector envs and greedy test episodes) with the same dynamics as the Anakin
engine, which steps the batched env on the device and never builds this adapter. The
resets' draws come from a CPU generator seeded by ``seed``."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sheeprl_tpu_torch.envs import core, spaces


class BatchedToGymEnv(core.Env):
    metadata = {"render_modes": []}

    def __init__(self, env_id: str, seed: Optional[int] = None, **env_kwargs):
        from sheeprl_tpu_torch.envs.batched import make_batched_env

        self._env = make_batched_env(env_id, **env_kwargs)
        self._params = self._env.default_params()
        self.observation_space = self._env.observation_space(self._params)
        self.action_space = self._env.action_space(self._params)
        self._gen = torch.Generator().manual_seed(0 if seed is None else int(seed))
        self._state = None

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self._gen.manual_seed(int(seed))
        # a plain step, no auto-reset: the vector env owns the reset protocol here
        self._state, obs = self._env.reset(self._params, self._env.reset_draws(self._params, (1,), self._gen))
        return obs[0].numpy(), {}

    def step(self, action):
        if isinstance(self.action_space, spaces.Discrete):
            act = torch.tensor([int(np.asarray(action).reshape(-1)[0])], dtype=torch.int32)
        else:
            act = torch.as_tensor(np.asarray(action, np.float32).reshape(1, -1))
        self._state, obs, reward, _done, info = self._env.step(self._params, self._state, act)
        return obs[0].numpy(), float(reward[0]), bool(info["terminated"][0]), bool(info["truncated"][0]), {}

    def render(self):
        return None
