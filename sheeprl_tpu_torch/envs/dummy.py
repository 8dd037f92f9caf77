"""Deterministic dummy environments — the CI workhorse.

A copy of ``sheeprl_tpu/envs/dummy.py`` (SheepRL's ``envs/dummy.py`` contract): dict
observation {rgb: uint8 [C,H,W], state: float} (or vector-only), fixed episode length,
frames filled with the step counter so pipelines are bit-checkable.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# the port's own subset of gymnasium's API (envs/core.py), not gymnasium itself
from sheeprl_tpu_torch.envs import core as gym


class _DummyEnv(gym.Env):
    metadata = {"render_modes": ["rgb_array"], "render_fps": 30}

    def __init__(
        self,
        image_size: Tuple[int, int, int] = (3, 64, 64),
        n_steps: int = 128,
        vector_shape: Tuple[int, ...] = (10,),
        dict_obs_space: bool = True,
    ):
        self._dict_obs_space = dict_obs_space
        if dict_obs_space:
            self.observation_space = gym.spaces.Dict(
                {
                    "rgb": gym.spaces.Box(0, 255, shape=image_size, dtype=np.uint8),
                    "state": gym.spaces.Box(-20, 20, shape=vector_shape, dtype=np.float32),
                }
            )
        else:
            self.observation_space = gym.spaces.Box(-20, 20, shape=vector_shape, dtype=np.float32)
        self.reward_range = (-np.inf, np.inf)
        self._current_step = 0
        self._n_steps = n_steps

    def _get_obs(self):
        if self._dict_obs_space:
            return {
                "rgb": np.full(self.observation_space["rgb"].shape, self._current_step % 256, dtype=np.uint8),
                "state": np.full(self.observation_space["state"].shape, self._current_step, dtype=np.float32),
            }
        return np.full(self.observation_space.shape, self._current_step, dtype=np.float32)

    def step(self, action):
        done = self._current_step == self._n_steps
        self._current_step += 1
        return self._get_obs(), 0.0, done, False, {}

    def reset(self, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        self._current_step = 0
        return self._get_obs(), {}

    def render(self):
        if self._dict_obs_space:
            return np.transpose(self._get_obs()["rgb"], (1, 2, 0))
        return np.zeros((64, 64, 3), dtype=np.uint8)

    def close(self):
        pass


class LineWalkDummyEnv(gym.Env):
    """A tiny solvable MDP for learning tests (no reference counterpart; VERDICT r2
    items 1/5): the agent walks on a line of ``length`` cells and is paid +1 for every
    step it spends on the rightmost cell.

    * actions: ``Discrete(3)`` — 0 stay, 1 left, 2 right;
    * obs: ``{rgb, state}`` — ``state`` is the one-hot position, ``rgb`` renders the
      position as a white vertical bar on black, so the reward is a function of the
      VISIBLE state only.  A pixels-only agent (``cnn_keys=[rgb]``) can therefore
      improve its return only if the whole pixels → world model → imagination →
      policy loop works;
    * known returns over ``n_steps=16``, ``length=6``: optimal ≈ ``n_steps - length + 1``
      (walk right, then stay), random walk ≲ 1.5.

    Episode ends by TRUNCATION at ``n_steps`` (the step counter is not observable, so
    a termination there would be unlearnable for the continue model).
    """

    metadata = {"render_modes": ["rgb_array"], "render_fps": 30}

    def __init__(
        self,
        length: int = 6,
        n_steps: int = 16,
        image_size: Tuple[int, int, int] = (3, 64, 64),
    ):
        self._length = length
        self._n_steps = n_steps
        self._image_size = image_size
        self.action_space = gym.spaces.Discrete(3)
        self.observation_space = gym.spaces.Dict(
            {
                "rgb": gym.spaces.Box(0, 255, shape=image_size, dtype=np.uint8),
                "state": gym.spaces.Box(0.0, 1.0, shape=(length,), dtype=np.float32),
            }
        )
        self.reward_range = (0.0, 1.0)
        self._pos = 0
        self._current_step = 0

    def _get_obs(self):
        c, h, w = self._image_size
        rgb = np.zeros((c, h, w), dtype=np.uint8)
        band = max(w // self._length, 1)
        start = self._pos * band
        rgb[:, :, start : start + band] = 255
        state = np.zeros((self._length,), dtype=np.float32)
        state[self._pos] = 1.0
        return {"rgb": rgb, "state": state}

    def step(self, action):
        action = int(np.asarray(action).reshape(-1)[0])
        if action == 1:
            self._pos = max(self._pos - 1, 0)
        elif action == 2:
            self._pos = min(self._pos + 1, self._length - 1)
        reward = 1.0 if self._pos == self._length - 1 else 0.0
        self._current_step += 1
        truncated = self._current_step >= self._n_steps
        return self._get_obs(), reward, False, truncated, {}

    def reset(self, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        self._pos = 0
        self._current_step = 0
        return self._get_obs(), {}

    def render(self):
        return np.transpose(self._get_obs()["rgb"], (1, 2, 0))

    def close(self):
        pass


class ContinuousDummyEnv(_DummyEnv):
    def __init__(
        self,
        image_size: Tuple[int, int, int] = (3, 64, 64),
        n_steps: int = 128,
        vector_shape: Tuple[int, ...] = (10,),
        action_dim: int = 2,
        dict_obs_space: bool = True,
    ):
        self.action_space = gym.spaces.Box(-1.0, 1.0, shape=(action_dim,), dtype=np.float32)
        super().__init__(image_size=image_size, n_steps=n_steps, vector_shape=vector_shape, dict_obs_space=dict_obs_space)


class DiscreteDummyEnv(_DummyEnv):
    def __init__(
        self,
        image_size: Tuple[int, int, int] = (3, 64, 64),
        n_steps: int = 4,
        vector_shape: Tuple[int, ...] = (10,),
        action_dim: int = 2,
        dict_obs_space: bool = True,
    ):
        self.action_space = gym.spaces.Discrete(action_dim)
        super().__init__(image_size=image_size, n_steps=n_steps, vector_shape=vector_shape, dict_obs_space=dict_obs_space)


class MultiDiscreteDummyEnv(_DummyEnv):
    def __init__(
        self,
        image_size: Tuple[int, int, int] = (3, 64, 64),
        n_steps: int = 128,
        vector_shape: Tuple[int, ...] = (10,),
        action_dims: List[int] = [2, 2],
        dict_obs_space: bool = True,
    ):
        self.action_space = gym.spaces.MultiDiscrete(action_dims)
        super().__init__(image_size=image_size, n_steps=n_steps, vector_shape=vector_shape, dict_obs_space=dict_obs_space)
