"""Host-side replay buffers (counterpart of ``sheeprl_tpu/data/buffers.py``).

Storage is numpy (optionally memmap) on the host with layout ``[buffer_size, n_envs,
...]``, and sampling is numpy: the same code as the reference's, so a buffer seeded
alike draws the same rows. ``to_device`` hands a sampled batch to the run's device as
torch tensors.

* ``ReplayBuffer``: circular dict-of-ndarray store.
* ``SequentialReplayBuffer``: contiguous length-T sequences that ignore episode bounds;
  output ``[n_samples, sequence_length, batch_size, ...]``.
* ``EnvIndependentReplayBuffer``: one sub-buffer per env, so envs can add rows on their
  own (``indices``), as the DreamerV3 loop does at episode ends.
* ``EpisodeBuffer``: whole episodes, assembled from each env's open chunks, the oldest
  evicted first, sampled as sequences inside one episode (``prioritize_ends`` draws the
  starts near an episode's end more often); the DreamerV2 loop's ``buffer.type=episode``.

``EnvIndependentReplayBuffer.sample_idx`` draws (env, start) index pairs only, for the
device-resident mirror, and ``ReplayBuffer.sample_idx`` (env, row) pairs for the SAC
family's transition ring (``data/device_buffer.py``). Not ported: the staleness gauges and
the native gather (the numpy gather it falls back to is what runs here).
"""

from __future__ import annotations

import os
import shutil
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from sheeprl_tpu_torch.utils.memmap import MemmapArray


def _np(v: Any) -> np.ndarray:
    return v.array if isinstance(v, MemmapArray) else np.asarray(v)


class ReplayBuffer:
    batch_axis: int = 1

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        memmap: bool = False,
        memmap_dir: Optional[os.PathLike] = None,
        memmap_mode: str = "r+",
        **kwargs: Any,
    ):
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"The number of environments must be greater than zero, got: {n_envs}")
        self._buffer_size = buffer_size
        self._n_envs = n_envs
        self._obs_keys = tuple(obs_keys)
        self._memmap = memmap
        self._memmap_dir = Path(memmap_dir) if memmap_dir is not None else None
        self._memmap_mode = memmap_mode
        if self._memmap:
            if memmap_mode not in ("r+", "w+", "c", "copyonwrite", "readwrite", "write"):
                raise ValueError(
                    "Accepted values for memmap_mode are 'r+', 'readwrite', 'w+', 'write', 'c' or 'copyonwrite'."
                )
            if self._memmap_dir is None:
                raise ValueError("memmap=True requires a `memmap_dir`.")
            self._memmap_dir.mkdir(parents=True, exist_ok=True)
        self._buf: Dict[str, np.ndarray | MemmapArray] = {}
        self._pos = 0
        self._full = False
        self._rng = np.random.default_rng()
        # staleness: each row's write stamp in rows added so far (Health/replay_age_*)
        self._stamps = np.zeros(buffer_size, np.int64)
        self._rows_added = 0
        self._last_sample_ages: Optional[Tuple[float, float]] = None

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def full(self) -> bool:
        return self._full

    @property
    def empty(self) -> bool:
        return (not self._full) and self._pos == 0

    @property
    def is_memmap(self) -> bool:
        return self._memmap

    def __len__(self) -> int:
        return self._buffer_size if self._full else self._pos

    def seed(self, seed: Optional[int] = None) -> None:
        self._rng = np.random.default_rng(seed)

    def _init_storage(self, key: str, shape: Sequence[int], dtype: np.dtype) -> None:
        full_shape = (self._buffer_size, self._n_envs, *shape)
        if self._memmap:
            filename = self._memmap_dir / f"{key}.memmap"
            self._buf[key] = MemmapArray(dtype=dtype, shape=full_shape, mode=self._memmap_mode, filename=filename)
        else:
            self._buf[key] = np.zeros(full_shape, dtype=dtype)

    def add(self, data: Dict[str, np.ndarray], validate_args: bool = False) -> None:
        """Append ``[T, n_envs, ...]`` arrays, wrapping circularly."""
        if validate_args:
            if not isinstance(data, dict):
                raise ValueError(f"`data` must be a dictionary of numpy arrays, got {type(data)}")
            shapes = {k: np.asarray(v).shape[:2] for k, v in data.items()}
            if len(set(shapes.values())) > 1:
                raise RuntimeError(f"Every array in `data` must agree on [T, n_envs]: {shapes}")
            for k, v in data.items():
                if np.asarray(v).ndim < 2:
                    raise RuntimeError(f"`data[{k}]` must have shape [T, n_envs, ...], got {np.asarray(v).shape}")
                if np.asarray(v).shape[1] != self._n_envs:
                    raise RuntimeError(f"`data[{k}]` has n_envs={np.asarray(v).shape[1]}, expected {self._n_envs}")
        steps = np.asarray(next(iter(data.values()))).shape[0]
        for k, v in data.items():
            v = np.asarray(v)
            if k not in self._buf:
                self._init_storage(k, v.shape[2:], v.dtype)
            buf = self._buf[k]
            if steps >= self._buffer_size:  # only the trailing window survives
                buf[:] = v[-self._buffer_size :]
                continue
            buf[(self._pos + np.arange(steps)) % self._buffer_size] = v
        if steps >= self._buffer_size:
            self._stamps[:] = self._rows_added + steps - self._buffer_size + np.arange(self._buffer_size)
            self._rows_added += steps
            self._pos = 0
            self._full = True
        else:
            self._stamps[(self._pos + np.arange(steps)) % self._buffer_size] = self._rows_added + np.arange(steps)
            self._rows_added += steps
            new_pos = self._pos + steps
            if new_pos >= self._buffer_size:
                self._full = True
            self._pos = new_pos % self._buffer_size

    @property
    def rows_added(self) -> int:
        """The rows added so far (the staleness clock)."""
        return int(self._rows_added)

    def _note_sample_ages(self, rows: np.ndarray) -> None:
        """The ages of the rows just sampled: rows added since each was written."""
        if self._rows_added == 0:
            return
        ages = (self._rows_added - 1) - self._stamps[np.asarray(rows).reshape(-1)]
        self._last_sample_ages = (float(ages.mean()), float(ages.max()))

    def sample_age_metrics(self) -> Dict[str, float]:
        """``Health/replay_age_*`` of the latest sample, in rows added (``{}`` before the
        first sample)."""
        if self._last_sample_ages is None:
            return {}
        mean, mx = self._last_sample_ages
        return {"Health/replay_age_mean": mean, "Health/replay_age_max": mx}

    def sample(
        self, batch_size: int, sample_next_obs: bool = False, clone: bool = False, n_samples: int = 1, **kwargs: Any
    ) -> Dict[str, np.ndarray]:
        """Uniformly sample ``[n_samples, batch_size, ...]`` transitions."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be greater than 0")
        if self.empty:
            raise ValueError("No sample has been added to the buffer. Please add at least one via `add()`")
        batch_dim = batch_size * n_samples
        if self._full:
            if sample_next_obs:
                # _pos - 1 is excluded: its "next" row (_pos) is the oldest one
                idxes = (self._rng.integers(0, self._buffer_size - 1, size=batch_dim) + self._pos) % self._buffer_size
            else:
                idxes = self._rng.integers(0, self._buffer_size, size=batch_dim)
        else:
            upper = self._pos - 1 if sample_next_obs else self._pos
            if upper <= 0:
                raise ValueError("Not enough data to sample next observations")
            idxes = self._rng.integers(0, upper, size=batch_dim)
        env_idxes = self._rng.integers(0, self._n_envs, size=batch_dim)
        self._note_sample_ages(idxes)
        out: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            arr = _np(v)
            picked = arr[idxes, env_idxes]
            out[k] = (picked.copy() if clone else picked).reshape(n_samples, batch_size, *arr.shape[2:])
            if sample_next_obs and k in self._obs_keys:
                nxt = arr[(idxes + 1) % self._buffer_size, env_idxes]
                out[f"next_{k}"] = nxt.reshape(n_samples, batch_size, *arr.shape[2:])
        return out

    def sample_idx(self, batch_size: int, n_samples: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """``(env_idxes, rows)``, each ``[n_samples, batch_size]``: the pairs ``sample``
        draws (without next observations), the same draws from the same generator, for
        the device transition ring (``data/device_buffer.py``)."""
        if self.empty:
            raise ValueError("No sample has been added to the buffer. Please add at least one via `add()`")
        batch_dim = batch_size * n_samples
        rows = self._rng.integers(0, self._buffer_size if self._full else self._pos, size=batch_dim)
        envs = self._rng.integers(0, self._n_envs, size=batch_dim)
        self._note_sample_ages(rows)
        return envs.reshape(n_samples, batch_size), rows.reshape(n_samples, batch_size)

    def state_dict(self) -> Dict[str, Any]:
        """Memmap storage checkpoints as a reference to its flushed file (the rows
        already live on disk): ``{"memmap": filename, "dtype", "shape"}``; RAM storage
        by value, as a tensor. Once referenced by a checkpoint, a memmap file outlives
        the buffer object. Only tensors and plain values, so the checkpoint loads with
        ``torch.load(weights_only=True)``."""
        buf: Dict[str, Any] = {}
        for k, v in self._buf.items():
            if isinstance(v, MemmapArray):
                v.flush()
                v.has_ownership = False
                buf[k] = {"memmap": v.filename, "dtype": str(v.dtype), "shape": list(v.shape)}
            else:
                buf[k] = torch.from_numpy(_np(v).copy())
        return {"buffer": buf, "pos": self._pos, "full": self._full}

    def load_state_dict(self, state: Dict[str, Any]) -> "ReplayBuffer":
        """Restore a checkpointed buffer. Memmap references are copied into this
        buffer's own storage, so the resumed run never writes into files an older
        checkpoint references."""
        for k, v in state["buffer"].items():
            if isinstance(v, dict):
                try:
                    src = np.memmap(v["memmap"], dtype=np.dtype(v["dtype"]), mode="r", shape=tuple(v["shape"]))
                except (FileNotFoundError, OSError) as exc:
                    raise RuntimeError(
                        f"buffer checkpoint for key '{k}' references memmap storage at {v['memmap']!r}, which is "
                        "not readable: resuming needs the original run's memmap_buffer directory"
                    ) from exc
            else:
                src = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            if k not in self._buf:
                self._init_storage(k, src.shape[2:], src.dtype)
            self._buf[k][:] = src
        self._pos = state["pos"]
        self._full = state["full"]
        # the stamps are not checkpointed: rebuild them as if the held rows were added in
        # order, the newest last (as the reference does)
        n = len(self)
        self._stamps[:] = 0
        if n:
            self._stamps[(self._pos - 1 - np.arange(n)) % self._buffer_size] = n - 1 - np.arange(n)
        self._rows_added = n
        return self


class SequentialReplayBuffer(ReplayBuffer):
    """Contiguous-sequence sampling, ignoring episode boundaries."""

    batch_axis: int = 2

    def sample(
        self,
        batch_size: int,
        sample_next_obs: bool = False,
        clone: bool = False,
        n_samples: int = 1,
        sequence_length: int = 1,
        **kwargs: Any,
    ) -> Dict[str, np.ndarray]:
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be greater than 0")
        if self.empty:
            raise ValueError("No sample has been added to the buffer. Please add at least one via `add()`")
        if not self._full and self._pos - sequence_length + 1 < 1:
            raise ValueError(f"Cannot sample a sequence of length {sequence_length}. Data added so far: {self._pos}")
        if self._full and sequence_length > len(self):
            raise ValueError(f"Sequence length ({sequence_length}) longer than buffer ({len(self)})")
        batch_dim = batch_size * n_samples
        starts = self.sample_start_idxes(batch_dim, sequence_length)
        idxes = (starts[:, None] + np.arange(sequence_length, dtype=np.intp)[None, :]) % self._buffer_size  # [B*N, T]
        env_idxes = np.repeat(self._rng.integers(0, self._n_envs, size=batch_dim)[:, None], sequence_length, axis=1)
        out: Dict[str, np.ndarray] = {}
        for k, v in self._buf.items():
            arr = _np(v)
            picked = arr[idxes.ravel(), env_idxes.ravel()].reshape(n_samples, batch_size, sequence_length, *arr.shape[2:])
            out[k] = np.swapaxes(picked, 1, 2)  # [n_samples, T, B, ...]
            if clone:
                out[k] = out[k].copy()
            if sample_next_obs and k in self._obs_keys:
                nxt = arr[(idxes.ravel() + 1) % self._buffer_size, env_idxes.ravel()]
                nxt = nxt.reshape(n_samples, batch_size, sequence_length, *arr.shape[2:])
                out[f"next_{k}"] = np.swapaxes(nxt, 1, 2)
        return out


    def sample_start_idxes(self, batch_dim: int, sequence_length: int) -> np.ndarray:
        """Uniform valid sequence starts (also what the device mirror's index sampling
        draws, ``data/device_buffer.py``)."""
        if self._full:
            # valid starts: sequences that do not cross the write cursor
            first_range_end = self._pos - sequence_length + 1
            second_range_end = self._buffer_size if first_range_end >= 0 else self._buffer_size + first_range_end
            valid = np.concatenate([np.arange(0, max(first_range_end, 0)), np.arange(self._pos, second_range_end)]).astype(np.intp)
            starts = valid[self._rng.integers(0, len(valid), size=batch_dim)]
        else:
            starts = self._rng.integers(0, self._pos - sequence_length + 1, size=batch_dim)
        self._note_sample_ages(starts)
        return starts


class EnvIndependentReplayBuffer:
    """One sub-buffer per environment; a sample splits the batch uniformly across the
    non-empty sub-buffers."""

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        memmap: bool = False,
        memmap_dir: Optional[os.PathLike] = None,
        memmap_mode: str = "r+",
        buffer_cls: Type[ReplayBuffer] = ReplayBuffer,
        **kwargs: Any,
    ):
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"The number of environments must be greater than zero, got: {n_envs}")
        if memmap and memmap_dir is None:
            raise ValueError("memmap=True requires a `memmap_dir`.")
        self._n_envs = n_envs
        self._buffer_size = buffer_size
        self._concat_along_axis = buffer_cls.batch_axis
        self._buf = [
            buffer_cls(
                buffer_size=buffer_size,
                n_envs=1,
                obs_keys=obs_keys,
                memmap=memmap,
                memmap_dir=None if memmap_dir is None else Path(memmap_dir) / f"env_{i}",
                memmap_mode=memmap_mode,
                **kwargs,
            )
            for i in range(n_envs)
        ]
        self._rng = np.random.default_rng()

    @property
    def buffer(self) -> Sequence[ReplayBuffer]:
        return self._buf

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def is_memmap(self) -> Sequence[bool]:
        return [b.is_memmap for b in self._buf]

    def __len__(self) -> int:
        return sum(len(b) for b in self._buf)

    def seed(self, seed: Optional[int] = None) -> None:
        self._rng = np.random.default_rng(seed)
        for i, b in enumerate(self._buf):
            b.seed(None if seed is None else seed + i)

    def add(self, data: Dict[str, np.ndarray], indices: Optional[Sequence[int]] = None, validate_args: bool = False) -> None:
        if indices is None:
            indices = tuple(range(self._n_envs))
        if validate_args and len(indices) != next(iter(data.values())).shape[1]:
            raise ValueError("`indices` must match data's env dimension")
        for i, env_idx in enumerate(indices):
            self._buf[env_idx].add({k: np.asarray(v)[:, i : i + 1] for k, v in data.items()}, validate_args=validate_args)

    def sample(
        self, batch_size: int, sample_next_obs: bool = False, clone: bool = False, n_samples: int = 1, **kwargs: Any
    ) -> Dict[str, np.ndarray]:
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be greater than 0")
        valid = [i for i, b in enumerate(self._buf) if len(b) > 0]
        if not valid:
            raise ValueError("No sample has been added to the buffer.")
        counts = np.bincount(self._rng.integers(0, len(valid), size=batch_size), minlength=len(valid))
        parts = [
            self._buf[i].sample(batch_size=int(counts[j]), sample_next_obs=sample_next_obs, clone=clone, n_samples=n_samples, **kwargs)
            for j, i in enumerate(valid)
            if counts[j] > 0
        ]
        return {k: np.concatenate([p[k] for p in parts], axis=self._concat_along_axis) for k in parts[0]}

    def sample_idx(
        self, batch_size: int, sequence_length: int, env_range: Optional[Sequence[int]] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Index-only sequence sampling for the device mirror: ``(env_ids [B], starts
        [B])``, each env drawn uniformly among those (of ``env_range``) that hold a whole
        sequence, and each start by that env's sub-buffer."""
        candidates = range(self._n_envs) if env_range is None else env_range
        valid = [
            i
            for i in candidates
            if (self._buf[i].full and sequence_length <= len(self._buf[i]))
            or (not self._buf[i].full and self._buf[i]._pos - sequence_length + 1 >= 1)
        ]
        if not valid:
            raise ValueError(
                f"Cannot sample a sequence of length {sequence_length}: no env buffer in {list(candidates)} holds "
                f"enough data (per-env sizes: {[len(b) for b in self._buf]})."
            )
        env_ids = np.asarray(valid, np.intp)[self._rng.integers(0, len(valid), size=batch_size)]
        starts = np.empty(batch_size, np.intp)
        for i in np.unique(env_ids):
            sel = env_ids == i
            starts[sel] = self._buf[i].sample_start_idxes(int(sel.sum()), sequence_length)
        return env_ids, starts

    def sample_age_metrics(self) -> Dict[str, float]:
        """Staleness over the per-env sub-buffers (each in its own rows added): the mean
        of their means, the max of their maxes."""
        stats = [s for s in (b.sample_age_metrics() for b in self._buf) if s]
        if not stats:
            return {}
        return {
            "Health/replay_age_mean": float(np.mean([s["Health/replay_age_mean"] for s in stats])),
            "Health/replay_age_max": float(max(s["Health/replay_age_max"] for s in stats)),
        }

    def state_dict(self) -> Dict[str, Any]:
        return {"buffers": [b.state_dict() for b in self._buf]}

    def load_state_dict(self, state: Dict[str, Any]) -> "EnvIndependentReplayBuffer":
        for b, s in zip(self._buf, state["buffers"]):
            b.load_state_dict(s)
        return self


class EpisodeBuffer:
    """Whole-episode store. ``add`` appends each env's rows to its open episode; a row
    whose ``terminated`` or ``truncated`` is set closes it, and a closed episode of at
    least ``minimum_episode_length`` rows is stored, evicting the oldest episodes until
    the store holds at most ``buffer_size`` rows. ``sample`` draws an episode per batch
    element, then a sequence inside it; with ``prioritize_ends`` the start is drawn from a
    range ``sequence_length`` longer and clipped to the last start, so sequences that
    reach an episode's end come up more often. With ``memmap`` each stored episode lives
    in files of its own under ``memmap_dir``, removed when it is evicted."""

    batch_axis: int = 2

    def __init__(
        self,
        buffer_size: int,
        minimum_episode_length: int,
        n_envs: int = 1,
        obs_keys: Sequence[str] = ("observations",),
        prioritize_ends: bool = False,
        memmap: bool = False,
        memmap_dir: Optional[os.PathLike] = None,
    ):
        if buffer_size <= 0:
            raise ValueError(f"The buffer size must be greater than zero, got: {buffer_size}")
        if minimum_episode_length <= 0:
            raise ValueError(f"The minimum episode length must be greater than zero, got: {minimum_episode_length}")
        if buffer_size < minimum_episode_length:
            raise ValueError(
                f"The minimum episode length must be lower than the buffer size, got: bs={buffer_size} ml={minimum_episode_length}"
            )
        if memmap and memmap_dir is None:
            raise ValueError("memmap=True requires a `memmap_dir`.")
        self._buffer_size = buffer_size
        self._minimum_episode_length = minimum_episode_length
        self._n_envs = n_envs
        self._obs_keys = tuple(obs_keys)
        self._prioritize_ends = prioritize_ends
        self._memmap = memmap
        self._memmap_dir = Path(memmap_dir) if memmap_dir is not None else None
        if self._memmap_dir is not None:
            self._memmap_dir.mkdir(parents=True, exist_ok=True)
        self._open_episodes: List[List[Dict[str, np.ndarray]]] = [[] for _ in range(n_envs)]
        self._cum_lengths: List[int] = []
        self._buf: List[Dict[str, Any]] = []
        self._rng = np.random.default_rng()

    @property
    def buffer(self) -> Sequence[Dict[str, Any]]:
        return self._buf

    @property
    def n_envs(self) -> int:
        return self._n_envs

    def __len__(self) -> int:
        return self._cum_lengths[-1] if self._cum_lengths else 0

    def seed(self, seed: Optional[int] = None) -> None:
        self._rng = np.random.default_rng(seed)

    def add(self, data: Dict[str, np.ndarray], env_idxes: Optional[Sequence[int]] = None, validate_args: bool = False) -> None:
        """Append ``[T, len(env_idxes), ...]`` rows (all envs without ``env_idxes``)."""
        if validate_args:
            if not isinstance(data, dict):
                raise ValueError(f"`data` must be a dictionary of numpy arrays, got {type(data)}")
            if "terminated" not in data or "truncated" not in data:
                raise RuntimeError(f"data must contain `terminated` and `truncated` keys, got: {list(data)}")
            if env_idxes is not None and (np.asarray(env_idxes) >= self._n_envs).any():
                raise ValueError(f"env indices must be in [0, {self._n_envs}), given {env_idxes}")
        if env_idxes is None:
            env_idxes = range(self._n_envs)
        for i, env in enumerate(env_idxes):
            env_data = {k: np.asarray(v)[:, i] for k, v in data.items()}
            done = np.logical_or(env_data["terminated"], env_data["truncated"]).reshape(-1)
            ends = done.nonzero()[0].tolist()
            if not ends:
                self._open_episodes[env].append(env_data)
                continue
            start = 0
            for end in ends + ([len(done) - 1] if ends[-1] != len(done) - 1 else []):
                chunk = {k: v[start : end + 1] for k, v in env_data.items()}
                if len(next(iter(chunk.values()))) > 0:
                    self._open_episodes[env].append(chunk)
                start = end + 1
                last = self._open_episodes[env][-1] if self._open_episodes[env] else None
                if last is not None and bool(np.logical_or(last["terminated"][-1], last["truncated"][-1]).any()):
                    self._save_episode(self._open_episodes[env])
                    self._open_episodes[env] = []

    def _save_episode(self, chunks: Sequence[Dict[str, np.ndarray]]) -> None:
        if not chunks:
            raise RuntimeError("Invalid episode: an empty sequence was given.")
        episode = {k: np.concatenate([c[k] for c in chunks], axis=0) for k in chunks[0]}
        ends = np.logical_or(episode["terminated"], episode["truncated"]).reshape(-1)
        ep_len = ends.shape[0]
        if ends.nonzero()[0].size != 1 or not ends[-1]:
            raise RuntimeError("The episode must contain exactly one done at its last step")
        if ep_len < self._minimum_episode_length:
            raise RuntimeError(f"Episode too short (min {self._minimum_episode_length}), got {ep_len} steps")
        if ep_len > self._buffer_size:
            raise RuntimeError(f"Episode too long (max {self._buffer_size}), got {ep_len} steps")
        while self._buf and len(self) + ep_len > self._buffer_size:
            evicted = self._buf.pop(0)
            self._cum_lengths = [c - self._cum_lengths[0] for c in self._cum_lengths[1:]]
            if self._memmap:
                dirname = os.path.dirname(next(iter(evicted.values())).filename)
                for v in evicted.values():
                    v.has_ownership = True
                evicted.clear()
                shutil.rmtree(dirname, ignore_errors=True)
        self._buf.append(self._store(episode))
        self._cum_lengths.append(len(self) + ep_len)

    def _store(self, episode: Dict[str, np.ndarray]) -> Dict[str, Any]:
        if not self._memmap:
            return episode
        ep_dir = self._memmap_dir / f"episode_{uuid.uuid4().hex}"
        return {k: MemmapArray.from_array(v, filename=ep_dir / f"{k}.memmap") for k, v in episode.items()}

    def sample(
        self,
        batch_size: int,
        sample_next_obs: bool = False,
        n_samples: int = 1,
        sequence_length: int = 1,
    ) -> Dict[str, np.ndarray]:
        """``[n_samples, sequence_length, batch_size, ...]`` sequences, each inside one
        episode of at least ``sequence_length`` rows (one more with ``sample_next_obs``)."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError(f"'batch_size' ({batch_size}) and 'n_samples' ({n_samples}) must be greater than 0")
        lengths = np.diff([0] + self._cum_lengths)
        min_len = sequence_length + (1 if sample_next_obs else 0)
        valid = [ep for ep, ln in zip(self._buf, lengths) if ln >= min_len]
        if not valid:
            raise RuntimeError(f"No valid episodes in the buffer; add at least one episode of length >= {sequence_length}.")
        batch_dim = batch_size * n_samples
        ep_choice = self._rng.integers(0, len(valid), size=batch_dim)
        offsets = np.arange(sequence_length, dtype=np.intp)
        parts: Dict[str, list] = {k: [] for k in valid[0].keys()}
        if sample_next_obs:
            for k in self._obs_keys:
                parts[f"next_{k}"] = []
        for b in range(batch_dim):
            ep = valid[ep_choice[b]]
            ep_len = _np(ep["terminated"]).shape[0] - (1 if sample_next_obs else 0)
            upper = ep_len - sequence_length + 1 + (sequence_length if self._prioritize_ends else 0)
            idx = min(int(self._rng.integers(0, upper)), ep_len - sequence_length) + offsets
            for k in ep.keys():
                parts[k].append(_np(ep[k])[idx])
                if sample_next_obs and k in self._obs_keys:
                    parts[f"next_{k}"].append(_np(ep[k])[idx + 1])
        out = {}
        for k, v in parts.items():
            stacked = np.stack(v, axis=0).reshape(n_samples, batch_size, sequence_length, *v[0].shape[1:])
            out[k] = np.swapaxes(stacked, 1, 2)
        return out

    def state_dict(self) -> Dict[str, Any]:
        """The stored episodes and the open ones by value, as tensors (memmap episodes
        too), so that the checkpoint loads with ``torch.load(weights_only=True)``."""
        as_tensors = lambda ep: {k: torch.from_numpy(_np(v).copy()) for k, v in ep.items()}  # noqa: E731
        return {
            "episodes": [as_tensors(ep) for ep in self._buf],
            "cum_lengths": list(self._cum_lengths),
            "open_episodes": [[as_tensors(c) for c in chunks] for chunks in self._open_episodes],
        }

    def load_state_dict(self, state: Dict[str, Any]) -> "EpisodeBuffer":
        as_arrays = lambda ep: {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in ep.items()}  # noqa: E731
        self._buf, self._cum_lengths = [], []
        for ep in state["episodes"]:
            ep = as_arrays(ep)
            self._buf.append(self._store(ep))
            self._cum_lengths.append(len(self) + next(iter(ep.values())).shape[0])
        self._open_episodes = [[as_arrays(c) for c in chunks] for chunks in state["open_episodes"]]
        return self


def to_device(samples: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A sampled batch as torch tensors on ``device`` (copied from pinned host memory
    when the device is a GPU)."""
    out = {}
    for k, v in samples.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out
