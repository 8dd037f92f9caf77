"""Envs and picklable env thunks for the port's env-pool tests.

A pool worker is spawned, so it imports the module of every thunk it is handed: this one
imports numpy and the port's envs only (no torch, no JAX, no gymnasium). ``HangingEnv``
and ``CrashingEnv`` are the counterparts of ``tests/test_rollout/envs.py``'s;
``SeededCrashingEnv`` shows its reset's seed in its observation; ``ProbeEnv`` reports
what its process has loaded.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict

from sheeprl_tpu_torch.envs import core, dummy


class HangingEnv(dummy.DiscreteDummyEnv):
    """Blocks on its ``hang_at``-th step (0: never): a wedged simulator."""

    def __init__(self, hang_at: int = 0, **kwargs):
        super().__init__(**kwargs)
        self._hang_at = hang_at
        self._steps_taken = 0

    def step(self, action):
        self._steps_taken += 1
        if self._hang_at and self._steps_taken == self._hang_at:
            time.sleep(3600)
        return super().step(action)


class CrashingEnv(dummy.DiscreteDummyEnv):
    """Ends its process on its ``crash_at``-th step (0: never): a segfault or an OOM kill."""

    def __init__(self, crash_at: int = 0, **kwargs):
        super().__init__(**kwargs)
        self._crash_at = crash_at
        self._steps_taken = 0

    def step(self, action):
        self._steps_taken += 1
        if self._crash_at and self._steps_taken == self._crash_at:
            os._exit(13)
        return super().step(action)


class SeededCrashingEnv(CrashingEnv):
    """A ``CrashingEnv`` whose reset observation is a draw of its generator: the seed of a
    reset shows in its observation."""

    def reset(self, seed=None, options=None):
        obs, info = super().reset(seed=seed, options=options)
        obs["state"] = self.np_random.integers(0, 20, size=obs["state"].shape).astype(obs["state"].dtype)
        return obs, info


class ProbeEnv(dummy.DiscreteDummyEnv):
    """Its reset's info says whether its process loaded torch, JAX or the JAX package,
    whether torch initialised CUDA there, and holds a draw of the env's generator (which
    the reset's seed decides)."""

    def reset(self, seed=None, options=None):
        obs, _ = super().reset(seed=seed, options=options)
        torch = sys.modules.get("torch")
        return obs, {
            "draw": int(self.np_random.integers(1 << 30)),
            "torch_loaded": torch is not None,
            "cuda_initialized": bool(torch is not None and torch.cuda.is_initialized()),
            "jax_loaded": "jax" in sys.modules,
            "reference_loaded": any(m == "sheeprl_tpu" or m.startswith("sheeprl_tpu.") for m in sys.modules),
        }


ENVS = {
    "discrete": dummy.DiscreteDummyEnv,
    "multidiscrete": dummy.MultiDiscreteDummyEnv,
    "continuous": dummy.ContinuousDummyEnv,
    "hanging": HangingEnv,
    "crashing": CrashingEnv,
    "seeded_crashing": SeededCrashingEnv,
    "probe": ProbeEnv,
}


class Thunk:
    """``ENVS[name](**kwargs)`` under ``RecordEpisodeStatistics`` (``stats=True``)."""

    def __init__(self, name: str, stats: bool = True, **kwargs: Any):
        self.name, self.stats, self.kwargs = name, stats, kwargs

    def __call__(self):
        env = ENVS[self.name](**self.kwargs)
        return core.RecordEpisodeStatistics(env) if self.stats else env


def thunks(name: str, n: int, **kwargs: Any):
    return [Thunk(name, **kwargs) for _ in range(n)]


def worker_report(info: Dict[str, Any]) -> Dict[str, bool]:
    """The probe's flags over every env of a reset's batched info."""
    return {k: bool(info[k].any()) for k in ("torch_loaded", "cuda_initialized", "jax_loaded", "reference_loaded")}
