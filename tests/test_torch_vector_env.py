"""The PyTorch port's vector envs (in-process and one worker process per env) against
the JAX package's ``make_vector_env`` (gymnasium's vector envs, same-step autoreset),
over steps that cross episode ends: observations, rewards, flags, ``final_obs``, the
episode statistics and the info masks must be equal (exactly: the dummy envs are
deterministic)."""

import numpy as np
import pytest

from tests.test_torch_dv3_agent import compose_pair
from tests.test_torch_envs import _same_obs, _same_space

N_STEPS = 4  # episode length: 11 steps cross two resets


def _episode(info):
    src = info.get("final_info", {})
    if "episode" not in src:
        return None
    return {k: np.asarray(v)[src["_episode"]] for k, v in src["episode"].items() if k in ("r", "l")}


@pytest.mark.parametrize("sync", [True, False])
@pytest.mark.parametrize("env", ["discrete_dummy", "continuous_dummy"])
def test_vector_env_matches_jax(sync, env):
    from sheeprl_tpu.utils.env import make_vector_env as jax_make_vector_env
    from sheeprl_tpu_torch.utils.env import make_vector_env

    jcfg, tcfg = compose_pair([f"env={env}", f"env.wrapper.n_steps={N_STEPS}", "env.num_envs=3", f"env.sync_env={sync}"])
    jenvs, tenvs = jax_make_vector_env(jcfg, 7, 0), make_vector_env(tcfg, 7, 0)
    try:
        _same_space(tenvs.single_observation_space, jenvs.single_observation_space)
        _same_space(tenvs.single_action_space, jenvs.single_action_space)
        jobs, _ = jenvs.reset(seed=7)
        tobs, _ = tenvs.reset(seed=7)
        _same_obs(tobs, jobs)
        rng = np.random.default_rng(0)
        ends = 0
        for _ in range(11):
            if env == "discrete_dummy":
                actions = rng.integers(0, jenvs.single_action_space.n, size=3)
            else:
                actions = rng.uniform(-1, 1, size=(3, *jenvs.single_action_space.shape)).astype(np.float32)
            jout, tout = jenvs.step(actions), tenvs.step(actions)
            _same_obs(tout[0], jout[0])
            for a, b in zip(tout[1:4], jout[1:4]):
                np.testing.assert_array_equal(a, b)
            jinfo, tinfo = jout[4], tout[4]
            assert ("final_obs" in tinfo) == ("final_obs" in jinfo)
            if "final_obs" in jinfo:
                ends += 1
                np.testing.assert_array_equal(tinfo["_final_obs"], jinfo["_final_obs"])
                for t_final, j_final in zip(tinfo["final_obs"], jinfo["final_obs"]):
                    assert (t_final is None) == (j_final is None)
                    if j_final is not None:
                        _same_obs(t_final, j_final)
                te, je = _episode(tinfo), _episode(jinfo)
                assert te.keys() == je.keys()
                for k in je:
                    np.testing.assert_array_equal(te[k], je[k])
        assert ends == 2
    finally:
        jenvs.close()
        tenvs.close()


def test_async_vector_env_refuses_fork():
    from sheeprl_tpu_torch.envs.vector import AsyncVectorEnv

    with pytest.raises(ValueError):
        AsyncVectorEnv([], start_method="fork")
