"""Device-resident replay of the PyTorch port (``sheeprl_tpu_torch/data/device_buffer.py``)
against the JAX package's (``sheeprl_tpu/data/device_buffer.py``), on the CPU.

The same seeded rows go into both packages' host buffers and device rings through their
``make_rb_add``; the rings' rows, the gathered sequences and the sampled (env, start)
indices must be exactly equal. Then the port's train entry runs with
``buffer.device=True`` on the CPU, resumes from a checkpoint and rebuilds its ring from
the host buffer.
"""

import contextlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_dv3_agent import TINY

N_ENVS, CAP, SEQ = 3, 6, 4
ROW = {"rgb": ((3, 4, 4), np.uint8), "state": ((5,), np.float32)}
EXTRA = [("actions", 2), ("rewards", 1), ("terminated", 1), ("truncated", 1), ("is_first", 1)]
OBS_SPACE = {k: SimpleNamespace(shape=shape) for k, (shape, _) in ROW.items()}


def _row(rng, n):
    """One step's rows for ``n`` envs, in the DreamerV3 loop's ``[1, n, ...]`` layout."""
    out = {
        "rgb": rng.integers(0, 256, size=(1, n, 3, 4, 4), dtype=np.uint8),
        "state": rng.normal(size=(1, n, 5)).astype(np.float32),
        "actions": rng.normal(size=(1, n, 2)).astype(np.float32),
    }
    for k in ("rewards", "terminated", "truncated", "is_first"):
        out[k] = rng.normal(size=(1, n, 1)).astype(np.float32)
    return out


def _buffers(seed: int):
    from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer as JaxEnvBuffer
    from sheeprl_tpu.data.buffers import SequentialReplayBuffer as JaxSeq
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer

    obs_keys = list(ROW)
    jrb = JaxEnvBuffer(CAP, n_envs=N_ENVS, obs_keys=obs_keys, buffer_cls=JaxSeq)
    trb = EnvIndependentReplayBuffer(CAP, n_envs=N_ENVS, obs_keys=obs_keys, buffer_cls=SequentialReplayBuffer)
    jrb.seed(seed)
    trb.seed(seed)
    return jrb, trb


def _filled(seed: int, steps: int):
    """Both packages' host buffers and rings after ``steps`` loop iterations: every env
    adds a row, and every third iteration env 1 adds an extra (episode-end) row."""
    from sheeprl_tpu.data import device_buffer as jdb
    from sheeprl_tpu_torch.data import device_buffer as tdb

    jrb, trb = _buffers(seed)
    jm = jdb.make_mirror_for(jrb, ["rgb"], ["state"], OBS_SPACE, EXTRA)
    tm = tdb.make_mirror_for(trb, ["rgb"], ["state"], OBS_SPACE, EXTRA, torch.device("cpu"))
    jadd = jdb.make_rb_add(jm, jrb, contextlib.nullcontext(), N_ENVS)
    tadd = tdb.make_rb_add(tm, trb, contextlib.nullcontext(), N_ENVS)
    rng = np.random.default_rng(seed)
    for t in range(steps):
        row = _row(rng, N_ENVS)
        jadd(row)
        tadd(row)
        if t % 3 == 2:
            extra = _row(rng, 1)
            jadd(extra, [1])
            tadd(extra, [1])
    return jrb, trb, jm, tm


def _host_rows(rb, key):
    """The host buffer's rows of ``key`` as ``[cap, n_envs, ...]``."""
    return np.stack([np.asarray(b._buf[key])[:, 0] for b in rb.buffer], 1)


@pytest.mark.parametrize("steps", [2, 6, 15])
def test_mirror_rows_after_add_equal_jax_and_the_host_buffer(steps):
    jrb, trb, jm, tm = _filled(0, steps)
    assert tm.nbytes == jm.nbytes
    for key in jm.arrays:
        got = tm.host_rows(key)
        np.testing.assert_array_equal(got, jm.host_rows(key))
        np.testing.assert_array_equal(got.reshape(CAP, N_ENVS, -1), _host_rows(trb, key).reshape(CAP, N_ENVS, -1))


def test_mirror_load_from_equals_jax_and_keeps_its_storage():
    from sheeprl_tpu.data import device_buffer as jdb
    from sheeprl_tpu_torch.data import device_buffer as tdb

    jrb, trb, jm, tm = _filled(1, 11)
    jfresh = jdb.make_mirror_for(jrb, ["rgb"], ["state"], OBS_SPACE, EXTRA)
    tfresh = tdb.make_mirror_for(trb, ["rgb"], ["state"], OBS_SPACE, EXTRA, torch.device("cpu"))
    pointers = {k: v.data_ptr() for k, v in tfresh.arrays.items()}
    jfresh.load_from(jrb)
    tfresh.load_from(trb)
    for key in jm.arrays:
        np.testing.assert_array_equal(tfresh.host_rows(key), jfresh.host_rows(key))
        np.testing.assert_array_equal(tfresh.host_rows(key), tm.host_rows(key))
    assert {k: v.data_ptr() for k, v in tfresh.arrays.items()} == pointers, "load_from must write in place"


def test_mirror_load_from_dense_equals_jax():
    from sheeprl_tpu.data.device_buffer import DeviceReplayMirror as JaxMirror
    from sheeprl_tpu_torch.data.device_buffer import DeviceReplayMirror

    rng = np.random.default_rng(2)
    specs = {"obs": ((2, 3), np.float32), "a": ((1,), np.uint8)}
    dense = {"obs": rng.normal(size=(CAP - 1, N_ENVS, 2, 3)).astype(np.float32), "a": rng.integers(0, 9, (CAP - 1, N_ENVS, 1), dtype=np.uint8)}
    jm, tm = JaxMirror(CAP, N_ENVS, specs), DeviceReplayMirror(CAP, N_ENVS, specs, torch.device("cpu"))
    jm.load_from_dense(dense)
    tm.load_from_dense(dense)
    for key in specs:
        np.testing.assert_array_equal(tm.host_rows(key), jm.host_rows(key))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_sequences_equals_jax_wrapping_past_capacity(seed):
    import jax.numpy as jnp

    from sheeprl_tpu.data.device_buffer import gather_sequences as jax_gather
    from sheeprl_tpu_torch.data.device_buffer import gather_sequences

    rng = np.random.default_rng(seed)
    rings = {
        "rgb": rng.integers(0, 256, size=(N_ENVS, CAP, 48), dtype=np.uint8),
        "state": rng.normal(size=(N_ENVS, CAP, 5)).astype(np.float32),
    }
    shapes = {"rgb": (3, 4, 4), "state": (5,)}
    envs = rng.integers(0, N_ENVS, size=7)
    starts = rng.integers(0, CAP, size=7)
    starts[0] = CAP - 1  # wraps past the capacity
    want = jax_gather({k: jnp.asarray(v) for k, v in rings.items()}, jnp.asarray(envs, jnp.int32), jnp.asarray(starts, jnp.int32), SEQ, shapes)
    got = gather_sequences({k: torch.from_numpy(v) for k, v in rings.items()}, torch.from_numpy(envs), torch.from_numpy(starts), SEQ, shapes)
    for k in rings:
        assert got[k].shape == (SEQ, 7, *shapes[k]) and got[k].dtype == torch.from_numpy(rings[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("steps", [5, 15])
def test_sample_idx_and_index_block_equal_jax(steps):
    from sheeprl_tpu.data.device_buffer import sample_index_block as jax_block
    from sheeprl_tpu_torch.data.device_buffer import sample_index_block

    jrb, trb, _, _ = _filled(3, steps)
    for _ in range(3):
        je, js = jrb.sample_idx(5, SEQ)
        te, ts = trb.sample_idx(5, SEQ)
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(ts, js)
    je, js = jax_block(jrb, 5, SEQ, 4)
    te, ts = sample_index_block(trb, 5, SEQ, 4)
    assert te.shape == ts.shape == (4, 5)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(ts, js)


def test_sample_idx_refuses_too_short_buffers_as_jax():
    jrb, trb, _, _ = _filled(4, 2)
    for rb in (jrb, trb):
        with pytest.raises(ValueError, match="Cannot sample a sequence"):
            rb.sample_idx(2, SEQ)


def test_gathered_batch_equals_the_host_buffers_sequences():
    """The ring's gather at sampled indices is the host buffer's own rows there."""
    from sheeprl_tpu_torch.data.device_buffer import sample_index_block

    _, trb, _, tm = _filled(5, 15)
    envs, starts = sample_index_block(trb, 4, SEQ, 2)
    gather = tm.make_gather_fn(SEQ)
    for g in range(2):
        batch = gather(torch.from_numpy(envs[g]), torch.from_numpy(starts[g]))
        for k in ("rgb", "actions", "is_first"):
            host = _host_rows(trb, k)  # [cap, n_envs, ...]
            want = np.stack([host[(starts[g][j] + np.arange(SEQ)) % CAP, envs[g][j]] for j in range(4)], 1)
            np.testing.assert_array_equal(batch[k].numpy(), want.reshape(batch[k].shape))


def test_make_mirror_for_has_the_reference_layout():
    from sheeprl_tpu.data import device_buffer as jdb
    from sheeprl_tpu_torch.data import device_buffer as tdb

    jrb, trb = _buffers(0)
    jm = jdb.make_mirror_for(jrb, ["rgb"], ["state"], OBS_SPACE, EXTRA)
    tm = tdb.make_mirror_for(trb, ["rgb"], ["state"], OBS_SPACE, EXTRA, torch.device("cpu"))
    assert {k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in jm.arrays.items()} == {
        k: (tuple(v.shape), v.numpy().dtype) for k, v in tm.arrays.items()
    }


def test_device_replay_refuses_data_parallelism():
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
    from sheeprl_tpu_torch.data.device_buffer import device_replay_enabled

    cfg = compose(overrides=[*TINY, "device=cpu"])
    rb = EnvIndependentReplayBuffer(8, n_envs=2, buffer_cls=SequentialReplayBuffer)
    assert device_replay_enabled(cfg, rb) is False
    cfg.buffer.device = True
    assert device_replay_enabled(cfg, rb) is True
    cfg.mesh.data = 2
    with pytest.raises(NotImplementedError, match="mesh.data"):
        device_replay_enabled(cfg, rb)


RUN = [
    *TINY,
    "device=cpu",
    "env.num_envs=2",
    "env.sync_env=True",
    "env.wrapper.n_steps=20",
    "algo.total_steps=64",
    "algo.learning_starts=16",
    "algo.replay_ratio=0.5",
    "checkpoint.every=32",
    "metric.log_every=16",
    "buffer.device=True",
]


@pytest.fixture()
def few_threads():
    """Two intra-op threads: the tiny agent gains nothing from more, and the suite's
    other workers share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_train_entry_with_device_replay_resumes_and_rebuilds_the_ring(tmp_path, monkeypatch, few_threads):
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.data import device_buffer
    from sheeprl_tpu_torch.utils import blocks

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    loads, dispatches = [], []
    real_load, real_dispatch = device_buffer.DeviceReplayMirror.load_from, blocks.IndexedBlockDispatcher.dispatch

    def load_from(self, rb):
        real_load(self, rb)
        loads.append(all(np.array_equal(self.host_rows(k).reshape(rb.buffer_size, rb.n_envs, -1),
                                        _host_rows(rb, k).reshape(rb.buffer_size, rb.n_envs, -1)) for k in self.arrays))

    def dispatch(self, envs, starts, start_count):
        dispatches.append(envs.shape)
        return real_dispatch(self, envs, starts, start_count)

    monkeypatch.setattr(device_buffer.DeviceReplayMirror, "load_from", load_from)
    monkeypatch.setattr(blocks.IndexedBlockDispatcher, "dispatch", dispatch)
    overrides = [*RUN, f"log_root={tmp_path / 'logs'}"]
    first = run(overrides)
    assert first.policy_steps == 64 and first.grad_steps >= 20 and loads == []
    assert sum(shape[0] for shape in dispatches) == first.grad_steps and all(shape[1] == 2 for shape in dispatches)
    ckpts = CheckpointManager(Path(first.log_dir) / "checkpoints").list_checkpoints()
    state = CheckpointManager.load(ckpts[-1])
    assert state["opt_states"]["world_model"]["count"] == state["cumulative_grad_steps"] == first.grad_steps

    resumed = run([*overrides, f"checkpoint.resume_from={ckpts[0]}"])
    assert loads == [True], "the resumed run rebuilds its ring from the restored host buffer"
    assert resumed.policy_steps == 64 and resumed.grad_steps > 0
    state = CheckpointManager.load(resumed.checkpoint)
    mid = CheckpointManager.load(ckpts[0])
    assert state["opt_states"]["world_model"]["count"] == mid["cumulative_grad_steps"] + resumed.grad_steps
