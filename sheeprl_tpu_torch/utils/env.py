"""Environment factory (counterpart of ``sheeprl_tpu/utils/env.py``): ``make_env`` and
``make_vector_env``.

Builds the wrapper pipeline: adapter -> ActionRepeat -> MaskVelocity -> dict-obs coercion ->
cv2 resize/grayscale -> FrameStack -> ActionsAsObservation -> RewardAsObservation ->
TimeLimit -> RecordEpisodeStatistics (video capture is not ported yet).  Observation contract downstream:
every env exposes a ``Dict`` space; CNN keys are uint8 channel-first ``[C, H, W]``
(``[stack, C, H, W]`` with frame stacking); MLP keys are flat float arrays.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np

# the port's own subset of gymnasium's API (envs/core.py), not gymnasium itself
from sheeprl_tpu_torch.envs import core as gym

from sheeprl_tpu_torch.envs.wrappers import (
    ActionRepeat,
    ActionsAsObservationWrapper,
    FrameStack,
    MaskVelocityWrapper,
    RewardAsObservationWrapper,
)
from sheeprl_tpu_torch.utils.imports import instantiate


class _PixelObservationWrapper(gym.Wrapper):
    """Add a render-based pixel key to a vector-only env (replaces the removed
    ``gym.wrappers.PixelObservationWrapper`` the reference relied on)."""

    def __init__(self, env: gym.Env, pixel_key: str, state_key: Optional[str] = None):
        super().__init__(env)
        self._pixel_key = pixel_key
        self._state_key = state_key
        frame = self._render_frame(reset_first=True)
        spaces = {pixel_key: gym.spaces.Box(0, 255, shape=frame.shape, dtype=np.uint8)}
        if state_key is not None:
            spaces[state_key] = env.observation_space
        self.observation_space = gym.spaces.Dict(spaces)

    def _render_frame(self, reset_first: bool = False) -> np.ndarray:
        if reset_first:
            self.env.reset()
        frame = self.env.render()
        if frame is None:
            raise RuntimeError(
                "Pixel observations requested but env.render() returned None; "
                "construct the env with render_mode='rgb_array'."
            )
        return np.asarray(frame)

    def _obs(self, obs: Any) -> Dict[str, Any]:
        out = {self._pixel_key: self._render_frame()}
        if self._state_key is not None:
            out[self._state_key] = obs
        return out

    def step(self, action):
        obs, reward, done, truncated, info = self.env.step(action)
        return self._obs(obs), reward, done, truncated, info

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self._obs(obs), info


class _DictObservation(gym.ObservationWrapper):
    """Wrap a plain Box observation into a single-key dict."""

    def __init__(self, env: gym.Env, key: str):
        super().__init__(env)
        self._key = key
        self.observation_space = gym.spaces.Dict({key: env.observation_space})

    def observation(self, observation):
        return {self._key: observation}


class _ImageTransform(gym.ObservationWrapper):
    """Resize / grayscale / channel-first coercion of CNN keys (reference ``:161-198``)."""

    def __init__(self, env: gym.Env, cnn_keys, screen_size: int, grayscale: bool):
        super().__init__(env)
        self._cnn_keys = list(cnn_keys)
        self._screen_size = screen_size
        self._grayscale = grayscale
        spaces = dict(env.observation_space.spaces)
        channels = 1 if grayscale else 3
        for k in self._cnn_keys:
            spaces[k] = gym.spaces.Box(0, 255, (channels, screen_size, screen_size), np.uint8)
        self.observation_space = gym.spaces.Dict(spaces)

    def observation(self, observation):
        observation = dict(observation)
        for k in self._cnn_keys:
            img = np.asarray(observation[k])
            is_3d = img.ndim == 3
            is_gray = not is_3d or img.shape[0] == 1 or img.shape[-1] == 1
            channel_first = not is_3d or img.shape[0] in (1, 3)
            if not is_3d:
                img = img[None]
            if channel_first:
                img = np.transpose(img, (1, 2, 0))
            # OpenCV is imported only where a frame needs it: the port's dummy-env path
            # runs on hosts without it.
            if img.shape[:2] != (self._screen_size, self._screen_size):
                import cv2

                img = cv2.resize(img, (self._screen_size, self._screen_size), interpolation=cv2.INTER_AREA)
            if self._grayscale and not is_gray:
                import cv2

                img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
            if img.ndim == 2:
                img = img[..., None]
                if not self._grayscale:
                    img = np.repeat(img, 3, axis=-1)
            observation[k] = np.transpose(img, (2, 0, 1)).astype(np.uint8)
        return observation


def make_env(
    cfg: Dict[str, Any],
    seed: int,
    rank: int,
    run_name: Optional[str] = None,
    prefix: str = "",
    vector_env_idx: int = 0,
) -> Callable[[], gym.Env]:
    """A callable that builds the env; picklable, so that a vector env can hand it to
    worker processes started with ``spawn``."""
    return _EnvThunk(cfg, seed, rank, run_name, prefix, vector_env_idx)


class _EnvThunk:
    def __init__(self, cfg, seed, rank, run_name, prefix, vector_env_idx):
        self.args = (cfg, seed, rank, run_name, prefix, vector_env_idx)

    def __call__(self) -> gym.Env:
        return _build_env(*self.args)


def _build_env(cfg, seed, rank, run_name, prefix, vector_env_idx) -> gym.Env:
    instantiate_kwargs = {}
    if "seed" in cfg.env.wrapper:
        instantiate_kwargs["seed"] = seed
    if "rank" in cfg.env.wrapper:
        instantiate_kwargs["rank"] = rank + vector_env_idx
    env = instantiate(cfg.env.wrapper, **instantiate_kwargs)

    if cfg.env.action_repeat > 1:
        env = ActionRepeat(env, cfg.env.action_repeat)
    if cfg.env.get("mask_velocities", False):
        env = MaskVelocityWrapper(env)

    cnn_sel = list(cfg.algo.cnn_keys.encoder or [])
    mlp_sel = list(cfg.algo.mlp_keys.encoder or [])
    if len(cnn_sel) + len(mlp_sel) == 0:
        raise ValueError(
            "`algo.cnn_keys.encoder` and `algo.mlp_keys.encoder` must be lists with at "
            f"least one key overall, got: cnn={cnn_sel} mlp={mlp_sel}"
        )

    # Coerce the observation space to a Dict (reference ``:98-140``).
    obs_space = env.observation_space
    if isinstance(obs_space, gym.spaces.Box) and len(obs_space.shape) < 2:
        if cnn_sel:
            if len(cnn_sel) > 1:
                warnings.warn(f"Only one pixel obs allowed for {cfg.env.id}; keeping {cnn_sel[0]}")
            env = _PixelObservationWrapper(
                env, pixel_key=cnn_sel[0], state_key=mlp_sel[0] if mlp_sel else None
            )
        else:
            if len(mlp_sel) > 1:
                warnings.warn(f"Only one vector obs allowed for {cfg.env.id}; keeping {mlp_sel[0]}")
            env = _DictObservation(env, mlp_sel[0])
    elif isinstance(obs_space, gym.spaces.Box) and 2 <= len(obs_space.shape) <= 3:
        if not cnn_sel:
            raise ValueError(
                "Pixel observation selected but no cnn key specified: set `algo.cnn_keys.encoder=[your_key]`"
            )
        if len(cnn_sel) > 1:
            warnings.warn(f"Only one pixel obs allowed for {cfg.env.id}; keeping {cnn_sel[0]}")
        env = _DictObservation(env, cnn_sel[0])

    if not isinstance(env.observation_space, gym.spaces.Dict):
        raise RuntimeError(f"Unsupported observation space: {env.observation_space}")
    env_keys = set(env.observation_space.spaces.keys())
    if not env_keys.intersection(cnn_sel + mlp_sel):
        raise ValueError(
            f"The user-specified keys {cnn_sel + mlp_sel} are not a subset of the "
            f"environment observation keys {sorted(env_keys)}."
        )

    env_cnn_keys = {k for k in env_keys if len(env.observation_space[k].shape) in (2, 3)}
    cnn_keys = sorted(env_cnn_keys.intersection(cnn_sel))
    if cnn_keys:
        env = _ImageTransform(env, cnn_keys, cfg.env.screen_size, cfg.env.grayscale)
        if cfg.env.frame_stack > 1:
            if cfg.env.frame_stack_dilation <= 0:
                raise ValueError(
                    f"The frame stack dilation argument must be greater than zero, got: {cfg.env.frame_stack_dilation}"
                )
            env = FrameStack(env, cfg.env.frame_stack, cnn_keys, cfg.env.frame_stack_dilation)

    if cfg.env.actions_as_observation.num_stack > 0:
        env = ActionsAsObservationWrapper(env, **cfg.env.actions_as_observation)
    if cfg.env.reward_as_observation:
        env = RewardAsObservationWrapper(env)

    env.action_space.seed(seed)
    env.observation_space.seed(seed)
    if cfg.env.max_episode_steps and cfg.env.max_episode_steps > 0:
        env = gym.TimeLimit(env, max_episode_steps=cfg.env.max_episode_steps)
    env = gym.RecordEpisodeStatistics(env)
    if cfg.env.capture_video and rank == 0 and vector_env_idx == 0 and run_name is not None:
        warnings.warn("Video capture is not ported yet; running without it")
    return env


def make_vector_env(cfg: Dict[str, Any], seed: int, rank: int, run_name: Optional[str] = None, prefix: str = ""):
    """The vector env of the training loops: ``env.num_envs`` envs, env ``i`` seeded
    ``seed + rank * num_envs + i``, with same-step autoreset. ``env.pool.enabled`` picks the
    shared-memory env pool (``rollout/pool.py``: worker processes over env groups, the step
    timeout, heartbeat and restarts of the ``rollout`` group); otherwise ``env.sync_env``
    picks the in-process vector env, else one worker process per env, started with
    ``spawn``."""
    from sheeprl_tpu_torch.envs.vector import AsyncVectorEnv, SyncVectorEnv

    n_envs = cfg.env.num_envs
    thunks = [make_env(cfg, seed + rank * n_envs + i, rank, run_name, prefix=prefix, vector_env_idx=i) for i in range(n_envs)]
    pool_cfg = cfg.env.get("pool") or {}
    if pool_cfg.get("enabled", False):
        from sheeprl_tpu_torch.rollout.pool import EnvPool

        rollout_cfg = cfg.get("rollout") or {}
        return EnvPool(
            thunks,
            num_workers=pool_cfg.get("num_workers"),
            step_timeout_s=rollout_cfg.get("step_timeout_s", 60.0),
            heartbeat_interval_s=rollout_cfg.get("heartbeat_interval_s", 2.0),
            max_restarts=rollout_cfg.get("max_restarts", 3),
            restart_backoff_s=rollout_cfg.get("restart_backoff_s", 0.5),
            start_method=rollout_cfg.get("start_method"),
        )
    return (SyncVectorEnv if cfg.env.sync_env else AsyncVectorEnv)(thunks)
