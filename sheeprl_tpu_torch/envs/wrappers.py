"""Generic environment wrappers (from ``sheeprl_tpu/envs/wrappers.py``; line cites are
SheepRL's ``envs/wrappers.py``).

Written against the port's subset of gymnasium's 1.x API (``envs/core.py``); the vector-env
and video wrappers come with the training slice:

* ``ActionRepeat`` (reference ``:48``) — repeat actions, accumulate rewards.
* ``MaskVelocityWrapper`` (``:13``) — zero out velocity entries of classic-control obs.
* ``FrameStack`` (``:126``) — deque-based stacking with dilation, dict-obs aware, stacks
  along a new leading axis per key producing ``[stack, C, H, W]``.
* ``RewardAsObservationWrapper`` (``:185``) — last reward appended to the obs dict.
* ``ActionsAsObservationWrapper`` (``:258``) — stack of past actions in the obs dict.
"""

from __future__ import annotations

import copy
from collections import deque
from typing import Any, Dict, Sequence, SupportsFloat, Tuple

import numpy as np

# the port's own subset of gymnasium's API (envs/core.py), not gymnasium itself
from sheeprl_tpu_torch.envs import core as gym


class ActionRepeat(gym.Wrapper):
    def __init__(self, env: gym.Env, amount: int):
        super().__init__(env)
        if amount <= 0:
            raise ValueError("`amount` should be a positive integer")
        self._amount = amount
        # Adapter fast path: an env exposing ``step_repeat(action, amount)`` runs the
        # repeat loop itself and materialises only the LAST observation (the generic
        # loop discards the intermediates, but the adapter has already paid to render
        # them — for pixel envs that is half the env wall-clock).  Bound only when
        # ActionRepeat wraps the adapter DIRECTLY — reaching through intermediate
        # wrappers would silently skip their step() logic.
        self._native = getattr(env, "step_repeat", None) if env.unwrapped is env else None

    @property
    def action_repeat(self) -> int:
        return self._amount

    def step(self, action: Any) -> Tuple[Any, SupportsFloat, bool, bool, Dict[str, Any]]:
        if self._native is not None:
            return self._native(action, self._amount)
        done = truncated = False
        total_reward = 0.0
        obs, info = None, {}
        for _ in range(self._amount):
            obs, reward, done, truncated, info = self.env.step(action)
            total_reward += float(reward)
            if done or truncated:
                break
        return obs, total_reward, done, truncated, info


class MaskVelocityWrapper(gym.ObservationWrapper):
    """Mask the velocity components of classic-control observations."""

    velocity_indices: Dict[str, np.ndarray] = {
        "CartPole-v0": np.array([1, 3]),
        "CartPole-v1": np.array([1, 3]),
        "MountainCar-v0": np.array([1]),
        "MountainCarContinuous-v0": np.array([1]),
        "Pendulum-v1": np.array([2]),
        "LunarLander-v2": np.array([2, 3, 5]),
        "LunarLanderContinuous-v2": np.array([2, 3, 5]),
    }

    def __init__(self, env: gym.Env):
        super().__init__(env)
        env_id = env.unwrapped.spec.id if env.unwrapped.spec is not None else ""
        if env_id not in self.velocity_indices:
            raise NotImplementedError(f"Velocity masking not implemented for {env_id}")
        self.mask = np.ones(env.observation_space.shape, dtype=np.float32)
        self.mask[self.velocity_indices[env_id]] = 0.0

    def observation(self, observation: np.ndarray) -> np.ndarray:
        return observation * self.mask


class FrameStack(gym.Wrapper):
    """Stack the last ``num_stack`` frames of the given dict keys, with dilation.

    Output per key: ``[num_stack, *frame_shape]`` (the encoder flattens stack × channel).
    """

    def __init__(self, env: gym.Env, num_stack: int, cnn_keys: Sequence[str], dilation: int = 1):
        super().__init__(env)
        if num_stack <= 0:
            raise ValueError(f"Invalid value for num_stack, expected a positive integer, got: {num_stack}")
        if dilation <= 0:
            raise ValueError(f"Invalid value for dilation, expected a positive integer, got: {dilation}")
        if not isinstance(env.observation_space, gym.spaces.Dict):
            raise RuntimeError(f"FrameStack requires a dict observation space, got: {type(env.observation_space)}")
        self._num_stack = num_stack
        self._dilation = dilation
        self._cnn_keys = [k for k in cnn_keys if k in env.observation_space.spaces]
        if not self._cnn_keys:
            raise RuntimeError(f"No valid cnn keys to stack: {cnn_keys}")
        self._frames: Dict[str, deque] = {k: deque(maxlen=num_stack * dilation) for k in self._cnn_keys}
        obs_space = copy.deepcopy(dict(env.observation_space.spaces))
        for k in self._cnn_keys:
            space = env.observation_space[k]
            obs_space[k] = gym.spaces.Box(
                low=np.repeat(space.low[None], num_stack, axis=0),
                high=np.repeat(space.high[None], num_stack, axis=0),
                shape=(num_stack, *space.shape),
                dtype=space.dtype,
            )
        self.observation_space = gym.spaces.Dict(obs_space)

    def _stacked(self, key: str) -> np.ndarray:
        frames = list(self._frames[key])[:: -self._dilation][::-1]
        return np.stack(frames, axis=0)

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        for k in self._cnn_keys:
            self._frames[k].append(obs[k])
            obs[k] = self._stacked(k)
        return obs, reward, done, truncated, info

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        for k in self._cnn_keys:
            self._frames[k].clear()
            for _ in range(self._num_stack * self._dilation):
                self._frames[k].append(obs[k])
            obs[k] = self._stacked(k)
        return obs, info


class RewardAsObservationWrapper(gym.Wrapper):
    def __init__(self, env: gym.Env):
        super().__init__(env)
        reward_space = gym.spaces.Box(-np.inf, np.inf, shape=(1,), dtype=np.float32)
        if isinstance(env.observation_space, gym.spaces.Dict):
            spaces = dict(env.observation_space.spaces)
            spaces["reward"] = reward_space
            self.observation_space = gym.spaces.Dict(spaces)
        else:
            self.observation_space = gym.spaces.Dict({"obs": env.observation_space, "reward": reward_space})

    def _wrap(self, obs: Any, reward: float) -> Dict[str, Any]:
        r = np.array([reward], dtype=np.float32)
        if isinstance(obs, dict):
            obs = dict(obs)
            obs["reward"] = r
        else:
            obs = {"obs": obs, "reward": r}
        return obs

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        return self._wrap(obs, float(reward)), reward, done, truncated, info

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self._wrap(obs, 0.0), info


class ActionsAsObservationWrapper(gym.Wrapper):
    """Expose the last ``num_stack`` executed actions in the obs dict under key
    ``action_stack`` (reference ``:258-342``); actions are noop-initialised on reset."""

    def __init__(self, env: gym.Env, num_stack: int, noop: Any, dilation: int = 1):
        super().__init__(env)
        if num_stack <= 0:
            raise ValueError(f"The number of actions to the stack must be greater than zero, got: {num_stack}")
        if dilation <= 0:
            raise ValueError(f"The dilation must be greater than zero, got: {dilation}")
        self._num_stack = num_stack
        self._dilation = dilation
        act_space = env.action_space
        if isinstance(act_space, gym.spaces.Discrete):
            self._per_action = int(act_space.n)
            if not isinstance(noop, int):
                raise ValueError(f"The noop action must be an integer for discrete action spaces, got: {noop}")
            self._noop = np.zeros(self._per_action, dtype=np.float32)
            self._noop[noop] = 1.0
        elif isinstance(act_space, gym.spaces.MultiDiscrete):
            if not isinstance(noop, (list, tuple)):
                raise ValueError(f"The noop actions must be a list for multi-discrete action spaces, got: {noop}")
            nvec = act_space.nvec
            if len(noop) != len(nvec):
                raise ValueError(f"The noop action must be a list of length {len(nvec)}, got: {len(noop)}")
            self._per_action = int(sum(nvec))
            self._noop = np.zeros(self._per_action, dtype=np.float32)
            offset = 0
            for n, a in zip(nvec, noop):
                self._noop[offset + int(a)] = 1.0
                offset += int(n)
        elif isinstance(act_space, gym.spaces.Box):
            self._per_action = int(np.prod(act_space.shape))
            if isinstance(noop, (int, float)):
                # scalar noop broadcasts over the action vector (reference accepts a float)
                noop = [float(noop)] * self._per_action
            if not isinstance(noop, (list, tuple)):
                raise ValueError(f"The noop action must be a float or list for continuous action spaces, got: {noop}")
            if len(noop) != self._per_action:
                raise ValueError(f"The noop action must be a list of length {self._per_action}, got: {len(noop)}")
            self._noop = np.asarray(noop, dtype=np.float32)
        else:
            raise ValueError(f"Unsupported action space: {type(act_space)}")
        self._actions: deque = deque(maxlen=num_stack * dilation)
        shape = (num_stack * self._per_action,)
        if isinstance(env.observation_space, gym.spaces.Dict):
            spaces = dict(env.observation_space.spaces)
        else:
            spaces = {"obs": env.observation_space}
        spaces["action_stack"] = gym.spaces.Box(-np.inf, np.inf, shape=shape, dtype=np.float32)
        self.observation_space = gym.spaces.Dict(spaces)

    def _encode(self, action: Any) -> np.ndarray:
        act_space = self.env.action_space
        if isinstance(act_space, gym.spaces.Discrete):
            out = np.zeros(self._per_action, dtype=np.float32)
            out[int(np.asarray(action).item())] = 1.0
            return out
        if isinstance(act_space, gym.spaces.MultiDiscrete):
            out = np.zeros(self._per_action, dtype=np.float32)
            offset = 0
            for n, a in zip(act_space.nvec, np.asarray(action).reshape(-1)):
                out[offset + int(a)] = 1.0
                offset += int(n)
            return out
        return np.asarray(action, dtype=np.float32).reshape(-1)

    def _obs(self, obs: Any) -> Dict[str, Any]:
        stacked = list(self._actions)[:: -self._dilation][::-1]
        action_stack = np.concatenate(stacked, axis=0).astype(np.float32)
        if isinstance(obs, dict):
            obs = dict(obs)
        else:
            obs = {"obs": obs}
        obs["action_stack"] = action_stack
        return obs

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        self._actions.append(self._encode(action))
        return self._obs(obs), reward, done, truncated, info

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        self._actions.clear()
        for _ in range(self._num_stack * self._dilation):
            self._actions.append(self._noop.copy())
        return self._obs(obs), info
