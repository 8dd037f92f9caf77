"""The PyTorch port's environment pipeline against the JAX package's.

The port carries its own subset of gymnasium's API (``sheeprl_tpu_torch/envs/core.py``
and ``spaces.py``), because the card's host has no gymnasium. Here both packages'
``make_env`` build the same configuration, and every observation, reward, flag, episode
statistic and space must be equal (exactly: the dummy envs are deterministic).
"""

import numpy as np
import pytest

from tests.test_torch_dv3_agent import compose_pair


def _same_space(port, ref):
    assert type(port).__name__ == type(ref).__name__
    if type(ref).__name__ == "Dict":
        assert list(port.spaces) == list(ref.spaces)
        for k in ref.spaces:
            _same_space(port[k], ref[k])
        return
    assert tuple(port.shape) == tuple(ref.shape) and port.dtype == ref.dtype
    if type(ref).__name__ == "Box":
        np.testing.assert_array_equal(port.low, ref.low)
        np.testing.assert_array_equal(port.high, ref.high)
    if type(ref).__name__ == "Discrete":
        assert port.n == ref.n
    if type(ref).__name__ == "MultiDiscrete":
        np.testing.assert_array_equal(port.nvec, ref.nvec)


def _same_obs(port, ref):
    assert list(port) == list(ref)
    for k in ref:
        assert np.asarray(port[k]).dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


@pytest.mark.parametrize(
    "extra",
    [
        ["env.wrapper.n_steps=5"],
        ["env=continuous_dummy", "env.max_episode_steps=3", "env.action_repeat=2"],
        ["env=multidiscrete_dummy", "env.frame_stack=3", "env.frame_stack_dilation=2", "env.screen_size=32"],
        ["env.reward_as_observation=True", "env.actions_as_observation.num_stack=2", "env.actions_as_observation.noop=0"],
    ],
)
def test_make_env_matches_the_jax_package(extra):
    from sheeprl_tpu.algos.dreamer_v3.agent import parse_actions_dim as jax_parse_actions_dim
    from sheeprl_tpu.utils.env import make_env as jax_make_env
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import parse_actions_dim
    from sheeprl_tpu_torch.utils.env import make_env

    jcfg, tcfg = compose_pair(["env.capture_video=False", *extra])
    ref, port = jax_make_env(jcfg, 3, 0, None)(), make_env(tcfg, 3, 0, None)()
    _same_space(port.observation_space, ref.observation_space)
    _same_space(port.action_space, ref.action_space)
    assert parse_actions_dim(port.action_space) == jax_parse_actions_dim(ref.action_space)
    (pobs, _), (robs, _) = port.reset(seed=3), ref.reset(seed=3)
    _same_obs(pobs, robs)
    for step in range(12):
        action = ref.action_space.sample()
        p, r = port.step(action), ref.step(action)
        _same_obs(p[0], r[0])
        assert (float(p[1]), bool(p[2]), bool(p[3])) == (float(r[1]), bool(r[2]), bool(r[3])), step
        assert ("episode" in p[4]) == ("episode" in r[4])
        if "episode" in r[4]:
            assert float(p[4]["episode"]["r"]) == float(np.asarray(r[4]["episode"]["r"]))
            assert int(p[4]["episode"]["l"]) == int(np.asarray(r[4]["episode"]["l"]))
        if r[2] or r[3]:
            (pobs, _), (robs, _) = port.reset(), ref.reset()
            _same_obs(pobs, robs)
    port.close()
    ref.close()


def test_spaces_sample_within_bounds_and_seed_repeatably():
    from sheeprl_tpu_torch.envs import spaces

    space = spaces.Dict(
        {
            "b": spaces.Box(-1.0, 1.0, (3,), np.float32),
            "a": spaces.Box(0, 255, (2, 2), np.uint8),
            "d": spaces.Discrete(4),
            "m": spaces.MultiDiscrete([2, 5]),
        }
    )
    assert list(space) == ["a", "b", "d", "m"]  # plain dicts are sorted, as in gymnasium
    space.seed(7)
    first = [space.sample() for _ in range(20)]
    assert all(s in space for s in first)
    space.seed(7)
    again = [space.sample() for _ in range(20)]
    for x, y in zip(first, again):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert spaces.Box(0, 1, (2,)) == spaces.Box(0, 1, (2,)) != spaces.Box(0, 2, (2,))
