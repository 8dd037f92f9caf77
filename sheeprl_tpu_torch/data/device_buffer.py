"""Device-resident replay: the replay rows live on the card, the host ships indices
(counterpart of the single-device part of ``sheeprl_tpu/data/device_buffer.py``).

* Every row appended to the host buffer is also written into a ``[n_envs, capacity,
  flat]`` ring on the device. The rows go up through pinned memory in a non-blocking
  copy on the current stream, the stream the captured step replays on, so a gather never
  reads a row mid-write.
* Sampling draws only (env, start) index pairs on the host, with the host buffer's own
  validity rules and generators, and the captured step gathers its ``[T, B]`` batch from
  the ring (``gather_sequences``): no batch crosses to the device.
* The host buffer stays the source of truth for checkpoints; ``load_from`` rebuilds the
  ring from it after a resume, in place, so the captured step's addresses stay valid.

Rows are stored flat and env-leading: rgb as uint8 ``[C*H*W]``, every other key as
float32. The reference's env-sharded ring (data parallelism) and its multi-process ring
are not ported: the port trains on one device, and the loop refuses ``mesh.data > 1``.

The SAC family's ``DeviceTransitionRing`` (``make_transition_replay``) is the same ring
over flat transitions (``obs``, ``next_obs``, ``actions``, ``rewards``, ``dones``): one
row per env per policy step, written at the host ``ReplayBuffer``'s cursor; its index
sampling draws (env, row) pairs on the host as the host buffer's ``sample`` does, and
the captured step gathers its ``[B]`` rows inside the graph. ``buffer.store_dtype=bf16``
keeps the float observation planes in bfloat16 and gathers them back as float32.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, ReplayBuffer


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def gather_sequences(
    mirror: Dict[str, torch.Tensor],
    envs: torch.Tensor,
    starts: torch.Tensor,
    sequence_length: int,
    row_shapes: Dict[str, Sequence[int]],
) -> Dict[str, torch.Tensor]:
    """``[T, B, ...]`` sequences from ``[n_envs, cap, flat]`` rings: batch element ``j``
    is env ``envs[j]``'s rows ``starts[j] .. starts[j] + T - 1``, wrapping modulo the
    capacity (the host's index sampling never lets a sequence cross the write cursor).
    ``row_shapes`` restores each key's row shape."""
    out = {}
    for k, buf in mirror.items():
        cap = buf.shape[1]
        t_idx = (starts[:, None] + torch.arange(sequence_length, device=starts.device, dtype=starts.dtype)) % cap
        picked = buf[envs[:, None], t_idx]  # [B, T, flat]
        out[k] = picked.transpose(0, 1).reshape(sequence_length, envs.shape[0], *row_shapes[k])
    return out


def _masked_row_update(
    bufs: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor], positions: torch.Tensor, mask: torch.Tensor
) -> None:
    """``bufs[k][e, positions[e]] = rows[k][e]`` for every env ``e`` with ``mask[e]``, in
    place. An unmasked env writes back the row it reads at its (any in-range) position:
    torch has no out-of-bounds-dropping scatter, and a write of one row per env keeps the
    update's shapes fixed."""
    for k, buf in bufs.items():
        env = torch.arange(buf.shape[0], device=buf.device)
        buf[env, positions] = torch.where(mask[:, None], rows[k].to(buf.dtype), buf[env, positions])


class DeviceReplayMirror:
    """A device ring mirroring an ``EnvIndependentReplayBuffer``'s rows.

    ``specs``: ``{key: (row shape, numpy dtype)}``. The write positions are the caller's
    (the host buffer's per-env cursors)."""

    def __init__(self, capacity: int, n_envs: int, specs: Dict[str, Tuple[Sequence[int], Any]], device: torch.device):
        self.capacity = int(capacity)
        self.n_envs = int(n_envs)
        self.specs = {k: (tuple(int(d) for d in shape), np.dtype(dtype)) for k, (shape, dtype) in specs.items()}
        self.device = torch.device(device)
        self._flat = {k: int(np.prod(shape)) for k, (shape, _) in self.specs.items()}
        self._row_shapes = {k: shape for k, (shape, _) in self.specs.items()}
        self.arrays: Dict[str, torch.Tensor] = {
            k: torch.zeros((self.n_envs, self.capacity, self._flat[k]), dtype=_torch_dtype(dtype), device=self.device)
            for k, (_, dtype) in self.specs.items()
        }

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays.values())

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(host))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def add(self, data: Dict[str, np.ndarray], envs: Sequence[int], positions: Sequence[int]) -> None:
        """Write one row per selected env: ``data[k]`` is ``[1, len(envs), ...]`` (the
        loop's row layout); ``positions[i]`` is env ``envs[i]``'s write cursor before the
        host add. A full ``[n_envs]`` block of rows goes up with a write mask."""
        env_sel = np.asarray(envs, np.intp)
        index = np.zeros((2, self.n_envs), np.int64)  # positions, mask
        index[0, env_sel] = np.asarray(positions, np.int64) % self.capacity
        index[1, env_sel] = 1
        rows = {}
        for k in self.arrays:
            host = np.zeros((self.n_envs, self._flat[k]), self.specs[k][1])
            host[env_sel] = np.asarray(data[k])[0].reshape(len(env_sel), self._flat[k])
            rows[k] = self._upload(host)
        index = self._upload(index)
        _masked_row_update(self.arrays, rows, index[0], index[1].bool())

    def _load(self, key: str, host: np.ndarray) -> None:
        self.arrays[key].copy_(self._upload(host))

    def load_from(self, host_rb) -> None:
        """Rebuild the ring from an ``EnvIndependentReplayBuffer`` (the resume path), in
        place: one copy per key."""
        for k in self.arrays:
            host = np.zeros(self.arrays[k].shape, self.specs[k][1])
            for e, sub in enumerate(host_rb.buffer):
                if k not in sub._buf:
                    continue
                arr = np.asarray(sub._buf[k])  # [cap, 1, ...]
                rows = min(arr.shape[0], self.capacity)
                host[e, :rows] = arr[:rows, 0].reshape(rows, self._flat[k])
            self._load(k, host)

    def load_from_dense(self, host_arrays: Dict[str, np.ndarray]) -> None:
        """Rebuild from dense ``[cap, n_envs, ...]`` host arrays (a plain
        ``ReplayBuffer``'s storage), in place."""
        for k in self.arrays:
            src = np.asarray(host_arrays[k])
            rows = min(src.shape[0], self.capacity)
            host = np.zeros(self.arrays[k].shape, self.specs[k][1])
            host[:, :rows] = np.moveaxis(src[:rows].reshape(rows, self.n_envs, self._flat[k]), 0, 1)
            self._load(k, host)

    def make_gather_fn(self, sequence_length: int):
        """``gather(envs, starts) -> {key: [T, B, *row_shape]}`` from this ring."""
        shapes = self._row_shapes
        return lambda envs, starts: gather_sequences(self.arrays, envs, starts, sequence_length, shapes)

    def host_rows(self, key: str) -> np.ndarray:
        """Ring ``key`` as ``[cap, n_envs, *row_shape]`` numpy (for tests)."""
        arr = self.arrays[key]
        arr = (arr.float() if arr.dtype == torch.bfloat16 else arr).cpu().numpy()  # [n_envs, cap, flat]
        return np.moveaxis(arr, 0, 1).reshape(self.capacity, self.n_envs, *self._row_shapes[key])


def device_replay_enabled(cfg, rb) -> bool:
    """Whether the loop replays from a device ring (``buffer.device``). One device only:
    the ring is not sharded, so a config that asks for data parallelism raises. The ring
    mirrors the sequential buffer only: with an ``EpisodeBuffer`` (DreamerV2's
    ``buffer.type=episode``) the loop logs it and samples on the host, as the reference
    does."""
    if not bool(cfg.buffer.get("device", False)):
        return False
    if not isinstance(rb, (EnvIndependentReplayBuffer, ReplayBuffer)):
        logging.getLogger(__name__).warning(
            "buffer.device=True supports only buffer.type=sequential (the episode buffer stays on the host); "
            "sampling on the host."
        )
        return False
    data = (cfg.get("mesh") or {}).get("data")
    if data not in (None, -1, 1):
        raise NotImplementedError(f"buffer.device=True with mesh.data={data!r}: the port's replay ring is not sharded")
    return True


def make_rb_add(mirror: Optional[DeviceReplayMirror], rb, rb_lock, num_envs: int):
    """The loop's row append: the host add, and the mirror's write at each target env's
    cursor before the add."""

    def rb_add(data, indices=None, validate_args=False):
        if mirror is not None:
            envs_sel = list(indices) if indices is not None else list(range(num_envs))
            positions = [rb.buffer[e]._pos for e in envs_sel]
            mirror.add(data, envs_sel, positions)
        with rb_lock:
            rb.add(data, indices, validate_args=validate_args)

    return rb_add


def sample_index_block(rb, batch_size: int, sequence_length: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` gradient steps' (env, start) index pairs as ``[n, B]`` arrays (the
    reference's ``dp=1`` case)."""
    idx = [rb.sample_idx(batch_size, sequence_length) for _ in range(n)]
    return np.stack([e for e, _ in idx]), np.stack([s for _, s in idx])


def row_specs(cnn_keys, mlp_keys, obs_space, extra_float_keys) -> Dict[str, Tuple[Sequence[int], Any]]:
    """The DreamerV3 loop's row layout (its ``obs_row``): pixel keys uint8 ``[C, H, W]``,
    vector keys flat float32, the extra keys float32 ``[dim]``."""
    specs: Dict[str, Tuple[Sequence[int], Any]] = {}
    for k in cnn_keys:
        shape = obs_space[k].shape
        specs[k] = ((int(np.prod(shape[:-2])), *shape[-2:]), np.uint8)
    for k in mlp_keys:
        specs[k] = ((int(np.prod(obs_space[k].shape)),), np.float32)
    for k, dim in extra_float_keys:
        specs[k] = ((int(dim),), np.float32)
    return specs


def make_mirror_for(rb, cnn_keys, mlp_keys, obs_space, extra_float_keys, device: torch.device) -> DeviceReplayMirror:
    """A mirror of the DreamerV3 loop's rows (``row_specs``) for the buffer ``rb``."""
    return DeviceReplayMirror(rb.buffer_size, rb.n_envs, row_specs(cnn_keys, mlp_keys, obs_space, extra_float_keys), device)


def make_device_replay(
    ctx, cfg, rb, cnn_keys, mlp_keys, obs_space, act_dim_sum: int, make_step, target_update_freq: int = 1, count_offset: int = 1
):
    """The loop's replay path, device or host: ``(dispatcher, mirror, prefetcher,
    run_block, rb_add)``. ``target_update_freq`` and ``count_offset`` set the target
    critic's cadence (``utils/blocks.py::target_flags``).

    ``make_step(example_inputs)`` builds the loop's captured step (``utils/graphs.py``)
    over static inputs and returns ``(step, draw)``; ``example_inputs`` is ``{"table",
    "gather"}`` for device replay (``gather(envs, starts)`` reads the ring inside the
    step) or ``{"table", "batch"}`` for host replay. ``run_block(n, start_count,
    stage_next=True)`` runs one iteration's ``n`` gradient steps through whichever path
    is on. The captured step is built before the prefetcher's thread starts."""
    from sheeprl_tpu_torch.data.prefetch import make_replay_prefetcher
    from sheeprl_tpu_torch.utils.blocks import BlockDispatcher, IndexedBlockDispatcher

    device = ctx.device
    batch_size = cfg.algo.per_rank_batch_size
    seq_len = cfg.algo.per_rank_sequence_length
    extra = [("actions", act_dim_sum), ("rewards", 1), ("terminated", 1), ("truncated", 1), ("is_first", 1)]
    if device_replay_enabled(cfg, rb):
        mirror = make_mirror_for(rb, cnn_keys, mlp_keys, obs_space, extra, device)
        table = torch.zeros(2 * batch_size + 1, dtype=torch.int64, device=device)  # envs, starts, flag
        step, draw = make_step({"table": table, "gather": mirror.make_gather_fn(seq_len)})
        dispatcher = IndexedBlockDispatcher(step, draw, target_update_freq, count_offset=count_offset)
        prefetcher, rb_lock = None, contextlib.nullcontext()

        def run_block(n: int, start_count: int, stage_next: bool = True) -> None:
            envs_idx, starts_idx = sample_index_block(rb, batch_size, seq_len, n)
            dispatcher.dispatch(envs_idx, starts_idx, start_count)

    else:
        mirror = None
        batch = {
            k: torch.zeros((seq_len, batch_size, *shape), dtype=_torch_dtype(dtype), device=device)
            for k, (shape, dtype) in row_specs(cnn_keys, mlp_keys, obs_space, extra).items()
        }
        table = torch.zeros(1, dtype=torch.int64, device=device)  # flag
        step, draw = make_step({"table": table, "batch": batch})
        dispatcher = BlockDispatcher(step, draw, target_update_freq, count_offset=count_offset)
        prefetcher, rb_lock, sample_block = make_replay_prefetcher(rb, device, cfg, batch_size, seq_len)

        def run_block(n: int, start_count: int, stage_next: bool = True) -> None:
            block = prefetcher.get(n, stage_next=stage_next) if prefetcher is not None else sample_block(n)
            dispatcher.dispatch(block, start_count)

    rb_add = make_rb_add(mirror, rb, rb_lock, rb.n_envs)
    return dispatcher, mirror, prefetcher, run_block, rb_add



STORE_DTYPE_KEYS = ("obs", "next_obs")


def resolve_store_dtype(spec: Any) -> Optional[torch.dtype]:
    """``buffer.store_dtype``: None (null, f32) or bfloat16 (bf16)."""
    key = "" if spec is None else str(spec).lower()
    if key in ("", "none", "null", "f32", "fp32", "float32"):
        return None
    if key in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"Unknown buffer.store_dtype {spec!r}; expected null, f32 or bf16")


class DeviceTransitionRing(DeviceReplayMirror):
    """A device ring of flat transitions mirroring a ``ReplayBuffer`` (the SAC family's;
    counterpart of ``sheeprl_tpu/data/device_buffer.py::DeviceTransitionRing``).

    ``specs``: ``{key: (row shape, numpy dtype)}``. With ``store_dtype`` (bfloat16) the
    float ``obs``/``next_obs`` planes are stored in it and gathered back in their spec's
    dtype. ``gather(envs, rows)`` returns ``{key: [B, *row shape]}``."""

    def __init__(self, capacity: int, n_envs: int, specs: Dict[str, Tuple[Sequence[int], Any]], device: torch.device, store_dtype: Optional[torch.dtype] = None):
        super().__init__(capacity, n_envs, specs, device)
        self.store_dtype = store_dtype
        self._cast: Dict[str, torch.dtype] = {}
        if store_dtype is not None:
            for k in STORE_DTYPE_KEYS:
                if k in self.arrays and self.arrays[k].is_floating_point():
                    self._cast[k] = self.arrays[k].dtype
                    self.arrays[k] = torch.zeros(self.arrays[k].shape, dtype=store_dtype, device=self.device)

    def add_step(self, data: Dict[str, np.ndarray], position: int) -> None:
        """Write one row for every env at slot ``position`` (the host buffer's cursor
        before its add); ``data[k]`` is ``[1, n_envs, ...]``."""
        self.add(data, range(self.n_envs), [position] * self.n_envs)

    def gather(self, envs: torch.Tensor, rows: torch.Tensor, arrays: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        out = {}
        for k, buf in (self.arrays if arrays is None else arrays).items():
            picked = buf[envs, rows]
            if k in self._cast:
                picked = picked.to(self._cast[k])
            out[k] = picked.reshape(envs.shape[0], *self._row_shapes[k])
        return out

    # The Anakin engine's ring (``engine/anakin.py``): it carries ring arrays of this
    # layout through its captured dispatch, writes each step's row at ``rows_added %
    # capacity`` (``rows_added`` a tensor on the device) and samples on the device.

    def population_arrays(self, size: int) -> Dict[str, torch.Tensor]:
        """Fresh ring arrays with a leading member axis, ``[size, n_envs, cap, flat]``
        per key, allocated at the stacked shape (stacking ``size`` copies would hold
        ``size`` more rings for a moment). Member ``m``'s ring is the view ``[m]``."""
        return {k: torch.zeros((int(size), *a.shape), dtype=a.dtype, device=self.device) for k, a in self.arrays.items()}

    def make_scan_writer(self):
        """``write(arrays, rows, rows_added)``: one transition row for every env, in
        place, at slot ``rows_added % capacity`` (``rows_added``, the rows added before
        this one, a 0-d integer tensor); ``rows[k]`` is ``[n_envs, *row_shape]``."""
        cap, n_envs, flat = self.capacity, self.n_envs, dict(self._flat)

        def write(arrays: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor], rows_added: torch.Tensor) -> Dict[str, torch.Tensor]:
            pos = torch.remainder(rows_added, cap).reshape(1)
            for k, buf in arrays.items():
                buf.index_copy_(1, pos, rows[k].reshape(n_envs, 1, flat[k]).to(buf.dtype))
            return arrays

        return write

    def sample_indices(self, filled: torch.Tensor, generator: Optional[torch.Generator], batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(envs, rows)``, ``[B]`` int64 each, drawn on the device: rows uniform over
        ``[0, max(filled, 1))`` and envs uniform over ``[0, n_envs)``, the host buffer's
        ``sample`` distribution. ``filled`` is a 0-d tensor, so the bound is read on the
        device (``torch.randint`` takes no tensor bound): a 62-bit draw modulo it."""
        device = filled.device
        rows = torch.randint(0, 1 << 62, (batch_size,), generator=generator, device=device) % torch.clamp(filled, min=1)
        envs = torch.randint(0, self.n_envs, (batch_size,), generator=generator, device=device)
        return envs, rows

    def make_sample_gather(self, batch_size: int):
        """``sample_gather(arrays, filled, generator, indices=None) -> batch``: the
        device draw of ``sample_indices`` (or the injected ``(envs, rows)``) and the
        gather of the ``[B, *row_shape]`` rows, the reduced storage planes cast back."""

        def sample_gather(arrays, filled, generator, indices=None):
            envs, rows = indices if indices is not None else self.sample_indices(filled, generator, batch_size)
            return self.gather(envs, rows, arrays)

        return sample_gather


def make_transition_dispatcher(ctx, cfg, rb: ReplayBuffer, specs: Dict[str, Tuple[Sequence[int], Any]], make_step, target_update_freq: int = 1, count_offset: int = 1):
    """The SAC family's block dispatcher over device or host replay: ``(ring,
    dispatcher)``.

    ``make_step(example_inputs)`` builds the loop's captured step over static inputs and
    returns ``(step, draw, select)``; ``example_inputs`` is ``{"table", "gather"}``
    (device replay: ``table`` is ``[2B + 1]`` int64, the (env, row) pairs and the
    target flag; ``gather(envs, rows)`` reads the ring inside the step) or ``{"table",
    "batch"}`` (host replay: ``batch`` holds ``[B, ...]`` per key of ``specs``, ``table``
    the flag). ``select``, where not None, picks the captured step per cumulative step
    count (``utils/blocks.py::make_train_block``). With ``buffer.device`` the ring is a
    ``DeviceTransitionRing`` and the dispatcher an ``IndexedBlockDispatcher`` (``[G, B]``
    (env, row) index arrays), else the ring is None and the dispatcher a
    ``BlockDispatcher`` (``[G, B, ...]`` batches on the device)."""
    from sheeprl_tpu_torch.utils.blocks import IndexedBlockDispatcher

    device = ctx.device
    batch_size = cfg.algo.per_rank_batch_size
    if device_replay_enabled(cfg, rb):
        ring = DeviceTransitionRing(rb.buffer_size, rb.n_envs, specs, device, resolve_store_dtype(cfg.buffer.get("store_dtype")))
        table = torch.zeros(2 * batch_size + 1, dtype=torch.int64, device=device)
        step, draw, select = make_step({"table": table, "gather": ring.gather})
        return ring, IndexedBlockDispatcher(step, draw, target_update_freq, count_offset=count_offset, select=select)
    if cfg.buffer.get("store_dtype") is not None and resolve_store_dtype(cfg.buffer.store_dtype) is not None:
        raise NotImplementedError(
            f"buffer.store_dtype={cfg.buffer.store_dtype}: the reduced storage dtype is the device ring's "
            "(buffer.device=True); the host buffer stores the rows as they are"
        )
    return None, make_host_dispatcher(ctx, cfg, specs, make_step, target_update_freq, count_offset)


def make_host_dispatcher(ctx, cfg, specs: Dict[str, Tuple[Sequence[int], Any]], make_step, target_update_freq: int = 1, count_offset: int = 1):
    """``make_transition_dispatcher``'s host-replay dispatcher: a ``BlockDispatcher`` over
    ``[G, B, ...]`` batches on the device (the Sebulba learner's too: its actors own the
    replay)."""
    from sheeprl_tpu_torch.utils.blocks import BlockDispatcher

    device, batch_size = ctx.device, cfg.algo.per_rank_batch_size
    batch = {k: torch.zeros((batch_size, *shape), dtype=_torch_dtype(dtype), device=device) for k, (shape, dtype) in specs.items()}
    table = torch.zeros(1, dtype=torch.int64, device=device)
    step, draw, select = make_step({"table": table, "batch": batch})
    return BlockDispatcher(step, draw, target_update_freq, count_offset=count_offset, select=select)


def make_transition_replay(ctx, cfg, rb: ReplayBuffer, specs: Dict[str, Tuple[Sequence[int], Any]], make_step, target_update_freq: int = 1, count_offset: int = 1, tail: int = 0):
    """The SAC family's replay path, device or host: ``(ring, prefetcher, run_block,
    rb_add)``, over ``make_transition_dispatcher``'s ring and dispatcher (its arguments
    as there).

    ``run_block(n, start_count, stage_next=True)`` runs ``n`` gradient steps and returns
    ``tail`` more samples for the caller (DroQ's actor step): index rows ``[tail, 2B]``
    (device) or ``{key: [tail, B, ...]}`` tensors on the device (host), or None.
    ``rb_add(data)`` appends one step's rows (``[1, n_envs, ...]`` per key) to the
    host buffer and the ring."""
    from sheeprl_tpu_torch.data.prefetch import make_replay_prefetcher

    batch_size = cfg.algo.per_rank_batch_size
    ring, dispatcher = make_transition_dispatcher(ctx, cfg, rb, specs, make_step, target_update_freq, count_offset)
    if ring is not None:
        prefetcher, rb_lock = None, contextlib.nullcontext()

        def run_block(n: int, start_count: int, stage_next: bool = True):
            envs_idx, rows_idx = rb.sample_idx(batch_size, n + tail)
            dispatcher.dispatch(envs_idx[:n], rows_idx[:n], start_count)
            return np.concatenate([envs_idx[n:], rows_idx[n:]], 1) if tail else None

    else:
        prefetcher, rb_lock, sample_block = make_replay_prefetcher(rb, ctx.device, cfg, batch_size, 1)

        def run_block(n: int, start_count: int, stage_next: bool = True):
            block = prefetcher.get(n + tail, stage_next=stage_next) if prefetcher is not None else sample_block(n + tail)
            dispatcher.dispatch({k: v[:n] for k, v in block.items()}, start_count)
            return {k: v[n:] for k, v in block.items()} if tail else None

    def rb_add(data: Dict[str, np.ndarray], validate_args: bool = False) -> None:
        if ring is not None:
            ring.add_step(data, rb._pos)
        with rb_lock:
            rb.add(data, validate_args=validate_args)

    run_block.dispatcher = dispatcher
    return ring, prefetcher, run_block, rb_add
