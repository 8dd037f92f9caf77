"""Vector environments with same-step autoreset (the subset of gymnasium's
``SyncVectorEnv``/``AsyncVectorEnv`` with ``AutoresetMode.SAME_STEP`` that the training
loops use; the card's host has no gymnasium).

``reset(seed=s)`` resets env ``i`` with seed ``s + i`` and returns the batched
observation (a dict of arrays stacked on a leading env axis) and info. ``step(actions)``
steps every env; an env whose episode ends is reset in the same step: its row of the
returned observation is the reset observation, and ``info["final_obs"]`` (an object
array, ``None`` for the other envs) and ``info["final_info"]`` hold what the ending step
returned. Infos are batched as gymnasium batches them: each key becomes an array over
envs beside a boolean mask ``_key``, recursively for dicts.

``SyncVectorEnv`` steps the envs in this process, ``AsyncVectorEnv`` one env per worker
process, started with ``spawn`` (never ``fork``: the parent may hold a CUDA context).
"""

from __future__ import annotations

import multiprocessing as mp
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


class VectorEnv:
    num_envs: int
    single_observation_space: Any
    single_action_space: Any

    def _add_info(self, vector_infos: Dict[str, Any], env_info: Dict[str, Any], env_num: int) -> Dict[str, Any]:
        for key, value in env_info.items():
            if key == "final_obs":
                array = vector_infos.get("final_obs")
                if array is None:
                    array = np.full(self.num_envs, fill_value=None, dtype=object)
                array[env_num] = value
            elif isinstance(value, dict):
                array = self._add_info(vector_infos.get(key, {}), value, env_num)
            else:
                if key not in vector_infos:
                    if type(value) in (int, float, bool) or issubclass(type(value), np.number):
                        array = np.zeros(self.num_envs, dtype=type(value))
                    elif isinstance(value, np.ndarray):
                        array = np.zeros((self.num_envs, *value.shape), dtype=value.dtype)
                    else:
                        array = np.full(self.num_envs, fill_value=None, dtype=object)
                else:
                    array = vector_infos[key]
                array[env_num] = value
            mask = vector_infos.get(f"_{key}", np.zeros(self.num_envs, dtype=np.bool_))
            mask[env_num] = True
            vector_infos[key], vector_infos[f"_{key}"] = array, mask
        return vector_infos

    def _batch(self, results: Sequence[tuple]):
        """Results of one step per env -> the batched step, infos added in env order
        (the ending step's ``final_obs``/``final_info`` before the reset's info)."""
        infos: Dict[str, Any] = {}
        obs, rewards = [], np.zeros(self.num_envs, np.float64)
        terminated, truncated = np.zeros(self.num_envs, np.bool_), np.zeros(self.num_envs, np.bool_)
        for i, (o, r, term, trunc, info, final) in enumerate(results):
            rewards[i], terminated[i], truncated[i] = r, term, trunc
            if final is not None:
                infos = self._add_info(infos, {"final_obs": final[0], "final_info": final[1]}, i)
            infos = self._add_info(infos, info, i)
            obs.append(o)
        return self._stack(obs), rewards, terminated, truncated, infos

    def _stack(self, obs: List[Any]) -> Any:
        if isinstance(obs[0], dict):
            return {k: np.stack([np.asarray(o[k]) for o in obs]) for k in obs[0]}
        return np.stack([np.asarray(o) for o in obs])

    def _reset_batch(self, results: Sequence[tuple]):
        infos: Dict[str, Any] = {}
        for i, (_, info) in enumerate(results):
            infos = self._add_info(infos, info, i)
        return self._stack([o for o, _ in results]), infos

    @staticmethod
    def _seeds(seed: Optional[int | Sequence[int]], n: int) -> List[Optional[int]]:
        if seed is None:
            return [None] * n
        if isinstance(seed, int):
            return [seed + i for i in range(n)]
        return list(seed)


def _step_same_step(env, action) -> tuple:
    obs, reward, terminated, truncated, info = env.step(action)
    final = None
    if terminated or truncated:
        final = (obs, info)
        obs, info = env.reset()
    return obs, reward, terminated, truncated, info, final


class SyncVectorEnv(VectorEnv):
    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space

    def reset(self, *, seed=None, options: Optional[dict] = None):
        seeds = self._seeds(seed, self.num_envs)
        return self._reset_batch([env.reset(seed=s, options=options) for env, s in zip(self.envs, seeds)])

    def step(self, actions):
        return self._batch([_step_same_step(env, a) for env, a in zip(self.envs, actions)])

    def close(self) -> None:
        for env in self.envs:
            env.close()


def _worker(env_fn, conn) -> None:
    env = None
    try:
        env = env_fn()
        conn.send(("ok", (env.observation_space, env.action_space)))
        while True:
            cmd, data = conn.recv()
            if cmd == "reset":
                conn.send(("ok", env.reset(seed=data[0], options=data[1])))
            elif cmd == "step":
                conn.send(("ok", _step_same_step(env, data)))
            elif cmd == "close":
                conn.send(("ok", None))
                return
    except (KeyboardInterrupt, EOFError):
        return
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        if env is not None:
            env.close()
        conn.close()


class AsyncVectorEnv(VectorEnv):
    def __init__(self, env_fns: Sequence[Callable[[], Any]], start_method: str = "spawn"):
        if start_method == "fork":
            raise ValueError("AsyncVectorEnv never forks: use spawn or forkserver")
        ctx = mp.get_context(start_method)
        self.num_envs = len(env_fns)
        self._conns, self._procs = [], []
        for fn in env_fns:
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_worker, args=(fn, child), daemon=True)
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)
        self._closed = False
        spaces = self._receive()
        self.single_observation_space, self.single_action_space = spaces[0]

    def _receive(self) -> List[Any]:
        out, errors = [], []
        for i, conn in enumerate(self._conns):
            try:
                status, payload = conn.recv()
            except EOFError:
                status, payload = "error", f"worker {i} exited"
            if status == "error":
                errors.append(f"env {i}:\n{payload}")
            out.append(payload)
        if errors:
            self.close(terminate=True)
            raise RuntimeError("vector env worker failed:\n" + "\n".join(errors))
        return out

    def reset(self, *, seed=None, options: Optional[dict] = None):
        for conn, s in zip(self._conns, self._seeds(seed, self.num_envs)):
            conn.send(("reset", (s, options)))
        return self._reset_batch(self._receive())

    def step(self, actions):
        for conn, a in zip(self._conns, actions):
            conn.send(("step", a))
        return self._batch(self._receive())

    def close(self, terminate: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        if not terminate:
            for conn in self._conns:
                try:
                    conn.send(("close", None))
                    conn.recv()
                except (BrokenPipeError, EOFError, OSError):
                    pass
        for proc in self._procs:
            proc.join(timeout=5)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
        for conn in self._conns:
            conn.close()

    def __del__(self):
        try:
            self.close(terminate=True)
        except Exception:
            pass
