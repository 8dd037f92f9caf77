"""The replay buffers of the PyTorch port against the JAX package's: the same rows
added, the same seed, the same samples (exact equality), in RAM and memmap storage;
and a checkpoint round trip of the port's buffer through its checkpoint manager."""

import numpy as np
import pytest
import torch

from sheeprl_tpu.data import buffers as jb
from sheeprl_tpu_torch.data import buffers as tb

N_ENVS, SIZE = 3, 20


def _rows(rng, t, n_envs=N_ENVS):
    return {
        "rgb": rng.integers(0, 256, size=(t, n_envs, 3, 4, 4), dtype=np.uint8),
        "state": rng.normal(size=(t, n_envs, 5)).astype(np.float32),
        "actions": rng.normal(size=(t, n_envs, 2)).astype(np.float32),
        "is_first": (rng.random((t, n_envs, 1)) < 0.1).astype(np.float32),
    }


def _fill(buf, seed, steps=(7, 9, 11)):
    rng = np.random.default_rng(seed)
    for t in steps:  # 27 rows per env: the ring wraps
        buf.add(_rows(rng, t))
    # decoupled adds, as at episode ends
    buf.add({k: v[:, :2] for k, v in _rows(rng, 2).items()}, indices=[2, 0])


def _pair(tmp_path, memmap):
    kw = dict(n_envs=N_ENVS, obs_keys=("rgb", "state"), memmap=memmap)
    j = jb.EnvIndependentReplayBuffer(SIZE, buffer_cls=jb.SequentialReplayBuffer, memmap_dir=tmp_path / "j" if memmap else None, **kw)
    t = tb.EnvIndependentReplayBuffer(SIZE, buffer_cls=tb.SequentialReplayBuffer, memmap_dir=tmp_path / "t" if memmap else None, **kw)
    for buf in (j, t):
        buf.seed(5)
        _fill(buf, seed=1)
    return j, t


@pytest.mark.parametrize("memmap", [False, True])
def test_sequential_samples_equal_jax(tmp_path, memmap):
    j, t = _pair(tmp_path, memmap)
    assert t.is_memmap == [memmap] * N_ENVS
    for batch, seq, n in ((4, 8, 1), (6, 5, 3), (1, 20, 2)):
        js = j.sample(batch, sequence_length=seq, n_samples=n)
        ts = t.sample(batch, sequence_length=seq, n_samples=n)
        assert sorted(js) == sorted(ts)
        for k in js:
            assert ts[k].shape == (n, seq, batch, *js[k].shape[3:])
            np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def test_replay_buffer_uniform_samples_equal_jax():
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    j, t = jb.ReplayBuffer(SIZE, N_ENVS, obs_keys=("state",)), tb.ReplayBuffer(SIZE, N_ENVS, obs_keys=("state",))
    for buf, rng in ((j, rng_j), (t, rng_t)):
        buf.seed(2)
        for steps in (8, 15):
            buf.add(_rows(rng, steps))
    for next_obs in (False, True):
        js, ts = j.sample(7, sample_next_obs=next_obs, n_samples=2), t.sample(7, sample_next_obs=next_obs, n_samples=2)
        assert sorted(js) == sorted(ts)
        for k in js:
            np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


@pytest.mark.parametrize("memmap", [False, True])
def test_checkpoint_round_trip(tmp_path, memmap):
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager

    _, t = _pair(tmp_path, memmap)
    path = CheckpointManager(tmp_path / "ckpts").save(1, {"rb": t.state_dict()})
    state = CheckpointManager.load(path)  # torch.load(weights_only=True)
    restored = tb.EnvIndependentReplayBuffer(
        SIZE, N_ENVS, obs_keys=("rgb", "state"), memmap=memmap, memmap_dir=tmp_path / "r" if memmap else None,
        buffer_cls=tb.SequentialReplayBuffer,
    ).load_state_dict(state["rb"])
    t.seed(9)
    restored.seed(9)
    a, b = t.sample(5, sequence_length=6, n_samples=2), restored.sample(5, sequence_length=6, n_samples=2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if memmap:  # the restored buffer owns fresh files, not the checkpointed ones
        assert all(sub.is_memmap for sub in restored.buffer)
        assert str(tmp_path / "r") in restored.buffer[0]._buf["rgb"].filename


def test_to_device_gives_tensors():
    out = tb.to_device({"x": np.arange(6, dtype=np.float32).reshape(2, 3)[:, ::2]}, torch.device("cpu"))
    assert out["x"].dtype == torch.float32 and out["x"].tolist() == [[0.0, 2.0], [3.0, 5.0]]
