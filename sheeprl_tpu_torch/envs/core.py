"""The environment interface: the subset of gymnasium's API (1.x) that the port's
environments and wrappers use, so that the port runs on hosts without gymnasium.

``Env``: ``reset(seed=, options=) -> (obs, info)``, ``step(action) -> (obs, reward,
terminated, truncated, info)``, ``render``, ``close``, ``unwrapped``, ``np_random``.
``Wrapper`` forwards everything to the wrapped env unless it overrides it;
``ObservationWrapper`` maps every observation through ``observation()``. ``TimeLimit``
and ``RecordEpisodeStatistics`` behave as gymnasium's wrappers of the same names.
Spaces are in ``sheeprl_tpu_torch.envs.spaces``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces  # noqa: F401  (re-export: core.spaces.Box, ...)


class Env:
    metadata: Dict[str, Any] = {"render_modes": []}
    render_mode: Optional[str] = None
    spec: Any = None
    reward_range = (-float("inf"), float("inf"))
    observation_space: spaces.Space
    action_space: spaces.Space
    _np_random: Optional[np.random.Generator] = None

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = np.random.default_rng()
        return self._np_random

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None) -> Tuple[Any, dict]:
        if seed is not None:
            self._np_random = np.random.default_rng(seed)
        return None, {}

    def step(self, action: Any) -> Tuple[Any, float, bool, bool, dict]:
        raise NotImplementedError

    def render(self) -> Any:
        return None

    def close(self) -> None:
        pass

    @property
    def unwrapped(self) -> "Env":
        return self


class Wrapper(Env):
    def __init__(self, env: Env):
        self.env = env
        self._observation_space: Optional[spaces.Space] = None
        self._action_space: Optional[spaces.Space] = None

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(f"accessing private attribute '{name}' is prohibited")
        return getattr(self.env, name)

    @property
    def observation_space(self) -> spaces.Space:
        return self.env.observation_space if self._observation_space is None else self._observation_space

    @observation_space.setter
    def observation_space(self, space: spaces.Space) -> None:
        self._observation_space = space

    @property
    def action_space(self) -> spaces.Space:
        return self.env.action_space if self._action_space is None else self._action_space

    @action_space.setter
    def action_space(self, space: spaces.Space) -> None:
        self._action_space = space

    @property
    def np_random(self) -> np.random.Generator:
        return self.env.np_random

    @property
    def metadata(self) -> Dict[str, Any]:
        return self.env.metadata

    @property
    def spec(self) -> Any:
        return self.env.spec

    @property
    def reward_range(self):
        return self.env.reward_range

    @property
    def unwrapped(self) -> Env:
        return self.env.unwrapped

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        return self.env.reset(seed=seed, options=options)

    def step(self, action: Any):
        return self.env.step(action)

    def render(self) -> Any:
        return self.env.render()

    def close(self) -> None:
        self.env.close()


class ObservationWrapper(Wrapper):
    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self.observation(obs), info

    def step(self, action: Any):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self.observation(obs), reward, terminated, truncated, info

    def observation(self, observation: Any) -> Any:
        raise NotImplementedError


class TimeLimit(Wrapper):
    """Truncate an episode after ``max_episode_steps`` steps."""

    def __init__(self, env: Env, max_episode_steps: int):
        super().__init__(env)
        self._max_episode_steps = int(max_episode_steps)
        self._elapsed_steps = 0

    def step(self, action: Any):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed_steps += 1
        return obs, reward, terminated, truncated or self._elapsed_steps >= self._max_episode_steps, info

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        self._elapsed_steps = 0
        return self.env.reset(seed=seed, options=options)


class RecordEpisodeStatistics(Wrapper):
    """At an episode's end, ``info["episode"] = {"r": return, "l": length, "t": seconds}``."""

    def __init__(self, env: Env):
        super().__init__(env)
        self._return = 0.0
        self._length = 0
        self._start = time.perf_counter()

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        self._return, self._length, self._start = 0.0, 0, time.perf_counter()
        return self.env.reset(seed=seed, options=options)

    def step(self, action: Any):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._return += float(reward)
        self._length += 1
        if terminated or truncated:
            info = dict(info)
            info["episode"] = {
                "r": np.float32(self._return),
                "l": np.int32(self._length),
                "t": np.float32(round(time.perf_counter() - self._start, 6)),
            }
        return obs, reward, terminated, truncated, info
