"""The PyTorch port's ``EpisodeBuffer`` (``sheeprl_tpu_torch/data/buffers.py``): the JAX
package's episode-buffer cases (``tests/test_data/test_episode_buffer.py``), and every
sample drawn under a seed equal, index for index, to the JAX package's buffer's under
the same seed and the same adds."""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.data.buffers import EpisodeBuffer


def _episode_data(length, n_envs=1, end=True):
    term = np.zeros((length, n_envs, 1), dtype=np.float32)
    if end:
        term[-1] = 1
    return {
        "observations": np.arange(length, dtype=np.float32).reshape(length, 1, 1).repeat(n_envs, 1),
        "terminated": term,
        "truncated": np.zeros_like(term),
    }


def test_add_complete_episode():
    eb = EpisodeBuffer(64, minimum_episode_length=2)
    eb.add(_episode_data(10))
    assert len(eb) == 10 and len(eb.buffer) == 1


def test_open_episode_not_stored():
    eb = EpisodeBuffer(64, minimum_episode_length=2)
    eb.add(_episode_data(5, end=False))
    assert len(eb) == 0
    eb.add(_episode_data(3))
    assert len(eb) == 8  # the chunks concatenated into one episode


def test_too_short_raises():
    eb = EpisodeBuffer(64, minimum_episode_length=5)
    with pytest.raises(RuntimeError):
        eb.add(_episode_data(3))


def test_eviction():
    eb = EpisodeBuffer(20, minimum_episode_length=2)
    for _ in range(4):
        eb.add(_episode_data(8))
    assert len(eb) <= 20 and len(eb.buffer) == 2


def test_sample_shapes():
    eb = EpisodeBuffer(64, minimum_episode_length=2)
    eb.add(_episode_data(20))
    s = eb.sample(3, sequence_length=6, n_samples=2)
    assert s["observations"].shape == (2, 6, 3, 1)
    assert np.allclose(np.diff(s["observations"][0, :, 0, 0]), 1)


def test_prioritize_ends():
    eb = EpisodeBuffer(64, minimum_episode_length=2, prioritize_ends=True)
    eb.add(_episode_data(10))
    s = eb.sample(64, sequence_length=4)
    # with prioritised ends the last step appears in some sampled sequence
    assert (s["observations"] == 9).any()


def test_sample_no_valid_raises():
    eb = EpisodeBuffer(64, minimum_episode_length=2)
    eb.add(_episode_data(3))
    with pytest.raises(RuntimeError):
        eb.sample(1, sequence_length=10)


def test_memmap(tmp_path):
    eb = EpisodeBuffer(20, minimum_episode_length=2, memmap=True, memmap_dir=tmp_path / "eb")
    eb.add(_episode_data(6))
    assert len(eb) == 6
    s = eb.sample(2, sequence_length=3)
    assert s["observations"].shape == (1, 3, 2, 1)
    for _ in range(3):  # evicting the oldest episodes removes their files
        eb.add(_episode_data(8))
    assert len(list((tmp_path / "eb").iterdir())) == len(eb.buffer) == 2


def _random_adds(seed: int, n_envs: int = 3, steps: int = 80):
    """The Dreamer loops' adds: each step a row of every env with no done flag, then,
    for the envs whose episode ended (at random), a row of the final observation with
    the flag set."""
    rng = np.random.default_rng(seed)
    row = lambda n, done: {  # noqa: E731
        "obs": rng.normal(size=(1, n, 4)).astype(np.float32),
        "rgb": rng.integers(0, 256, (1, n, 3, 2, 2), dtype=np.uint8),
        "terminated": np.full((1, n, 1), float(done), np.float32),
        "truncated": np.zeros((1, n, 1), np.float32),
    }
    adds = []
    for _ in range(steps):
        adds.append((row(n_envs, False), None))
        ended = np.nonzero(rng.random(n_envs) < 0.12)[0].tolist()
        if ended:
            adds.append((row(len(ended), True), ended))
    return adds


@pytest.mark.parametrize("prioritize_ends", [False, True])
@pytest.mark.parametrize("memmap", [False, True])
def test_seeded_samples_equal_the_jax_packages(tmp_path, prioritize_ends, memmap):
    """The same adds (with evictions) into both packages' buffers, seeded alike: every
    sample equal, index for index; and the port's state dict loads into a fresh buffer
    that samples the same."""
    from sheeprl_tpu.data.buffers import EpisodeBuffer as JaxEpisodeBuffer

    kw = dict(buffer_size=40, minimum_episode_length=1, n_envs=3, obs_keys=("obs", "rgb"), prioritize_ends=prioritize_ends)
    port = EpisodeBuffer(**kw, memmap=memmap, memmap_dir=tmp_path / "port" if memmap else None)
    ref = JaxEpisodeBuffer(**kw, memmap=memmap, memmap_dir=tmp_path / "jax" if memmap else None)
    port.seed(5)
    ref.seed(5)
    for data, idx in _random_adds(0):
        ref.add(data, idx)
        port.add(data, idx)
        assert len(port) == len(ref) and len(port.buffer) == len(ref.buffer)
        if len(ref):
            for seq, nxt in ((3, False), (2, True)):
                a = ref.sample(4, sequence_length=seq, n_samples=2, sample_next_obs=nxt)
                b = port.sample(4, sequence_length=seq, n_samples=2, sample_next_obs=nxt)
                assert set(a) == set(b)
                for k in a:
                    np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert len(ref.buffer) >= 3
    state = port.state_dict()
    assert all(isinstance(v, torch.Tensor) for ep in state["episodes"] for v in ep.values())
    again = EpisodeBuffer(**kw, memmap=memmap, memmap_dir=tmp_path / "again" if memmap else None).load_state_dict(state)
    assert len(again) == len(port) and len(again.buffer) == len(port.buffer)
    again.seed(9)
    port.seed(9)
    a, b = again.sample(5, sequence_length=3), port.sample(5, sequence_length=3)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
