"""The PyTorch port's batched envs (``sheeprl_tpu_torch/envs/batched``) against the JAX
package's pure-functional envs (``sheeprl_tpu/envs/jax``).

* One step from 4,096 sampled states and actions per env, the reference's ``step``
  vmapped over them: observation, reward, termination and truncation. Tolerance: atol
  1e-6 (float32; ``cos``/``sin`` of the two libraries may differ in the last bit).
* 64-step trajectories through ``step_autoreset`` from the same reset, the port handed
  the reset draws the reference's keys make (``jax.random.split`` per env step, then
  ``reset``'s ``uniform``): observations, rewards, dones and ``final_obs``. Tolerance:
  atol 1e-5 (a pole's angle error grows over an episode).
* The time limit, ``sample_action``'s bounds and dtypes, the registry's ids and errors,
  and the CPU adapter through the port's vector env (``env=jax_cartpole``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.envs.jax import make_jax_env
from sheeprl_tpu_torch.envs.batched import make_batched_env

ENVS = ("cartpole", "pendulum", "mountain_car_continuous")
N_STATES = 4096
STEP_ATOL = 1e-6
TRAJ_ATOL = 1e-5


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def sampled_states(name: str, rng: np.random.Generator, n: int, max_steps: int):
    """``n`` float32 physics states spread over the envs' interesting ranges (some past
    the termination thresholds), and time counters up to the limit."""
    time = rng.integers(0, max_steps, n).astype(np.int32)
    if name == "cartpole":
        cols = [rng.uniform(-2.6, 2.6, n), rng.normal(0, 2, n), rng.uniform(-0.25, 0.25, n), rng.normal(0, 2, n)]
        actions = rng.integers(0, 2, n).astype(np.int32)
    elif name == "pendulum":
        cols = [rng.uniform(-12, 12, n), rng.uniform(-9, 9, n)]
        actions = rng.uniform(-3, 3, (n, 1)).astype(np.float32)
    else:
        cols = [rng.uniform(-1.2, 0.6, n), rng.uniform(-0.07, 0.07, n)]
        cols[0][: n // 8] = -1.2  # on the left wall
        actions = rng.uniform(-1.5, 1.5, (n, 1)).astype(np.float32)
    return [c.astype(np.float32) for c in cols] + [time], actions


def as_state(state_cls, cols, lib):
    return state_cls(*(lib(c) for c in cols))


@pytest.mark.parametrize("name", ENVS)
def test_one_step_matches_jax(name):
    jenv, tenv = make_jax_env(name), make_batched_env(name)
    jp, tp = jenv.default_params(), tenv.default_params()
    cols, actions = sampled_states(name, np.random.default_rng(0), N_STATES, jp.max_episode_steps)
    jstate = as_state(type(jenv.reset(jp, jax.random.PRNGKey(0))[0]), cols, jnp.asarray)
    keys = jax.random.split(jax.random.PRNGKey(1), N_STATES)
    _, jobs, jrew, jdone, jinfo = jax.vmap(jenv.step, in_axes=(None, 0, 0, 0))(jp, jstate, jnp.asarray(actions), keys)
    tstate = as_state(type(tenv.reset(tp, torch.zeros(1, len(tenv.reset_bounds(tp)[0])))[0]), cols, torch.from_numpy)
    new, obs, rew, done, info = tenv.step(tp, tstate, torch.from_numpy(actions))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=STEP_ATOL, rtol=0)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), atol=STEP_ATOL * 20 if name == "pendulum" else STEP_ATOL, rtol=1e-6)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    for k in ("terminated", "truncated"):
        np.testing.assert_array_equal(info[k].numpy(), np.asarray(jinfo[k]), err_msg=k)
    assert obs.dtype == rew.dtype == torch.float32 and new.time.dtype == torch.int32
    assert info["truncated"].any() and (name == "pendulum" or info["terminated"].any())


def reference_reset_draws(jenv, jp, keys):
    """The values ``reset`` draws from each env's reset key (``step_autoreset``'s
    ``split``), as the port's ``[n, k]`` reset draws."""
    reset_keys = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    states = jax.vmap(jenv.reset, in_axes=(None, 0))(jp, reset_keys)[0]
    fields = [f for f in states._fields if f != "time"]
    if type(jenv).__name__ == "MountainCarContinuous":
        fields = ["position"]
    return np.stack([np.asarray(getattr(states, f)) for f in fields], -1)


@pytest.mark.parametrize("name", ENVS)
def test_trajectories_with_injected_resets_match_jax(name):
    n, steps = 16, 64
    jenv, tenv = make_jax_env(name), make_batched_env(name)
    jp, tp = jenv.default_params(), tenv.default_params()
    if name != "cartpole":  # short limits, so that the 64 steps cross a truncation
        jp, tp = jp._replace(max_episode_steps=23), tp._replace(max_episode_steps=23)
    key = jax.random.PRNGKey(3)
    jstate, jobs = jax.vmap(jenv.reset, in_axes=(None, 0))(jp, jax.random.split(key, n))
    first = np.stack([np.asarray(x) for x in jstate[:-1]], -1)[..., : len(tenv.reset_bounds(tp)[0])]
    if name == "mountain_car_continuous":
        first = np.asarray(jstate.position)[:, None]
    tstate, tobs = tenv.reset(tp, torch.from_numpy(np.array(first)))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=STEP_ATOL)
    vstep = jax.jit(jax.vmap(jenv.step_autoreset, in_axes=(None, 0, 0, 0)))
    rng = np.random.default_rng(4)
    dones = 0
    for t in range(steps):
        key, k = jax.random.split(key)
        keys = jax.random.split(k, n)
        if name == "cartpole":
            act = rng.integers(0, 2, n).astype(np.int32)
        else:
            act = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
        jstate, jobs, jrew, jdone, jinfo = vstep(jp, jstate, jnp.asarray(act), keys)
        draws = torch.from_numpy(reference_reset_draws(jenv, jp, keys))
        tstate, tobs, trew, tdone, tinfo = tenv.step_autoreset(tp, tstate, torch.from_numpy(act), draws=draws)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone), err_msg=f"step {t}")
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=TRAJ_ATOL, err_msg=f"step {t}")
        np.testing.assert_allclose(tinfo["final_obs"].numpy(), np.asarray(jinfo["final_obs"]), atol=TRAJ_ATOL, err_msg=f"step {t}")
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=TRAJ_ATOL * 10, rtol=1e-5, err_msg=f"step {t}")
        np.testing.assert_array_equal(tstate.time.numpy(), np.asarray(jstate.time))
        dones += int(tdone.sum())
    assert dones > 0


def test_time_limit_truncates_and_termination_wins():
    env = make_batched_env("cartpole")
    p = env.default_params()._replace(max_episode_steps=5)
    state, _ = env.reset(p, torch.zeros(3, 4))
    state = state._replace(time=torch.tensor([3, 4, 4], dtype=torch.int32), x=torch.tensor([0.0, 0.0, 2.5]))
    _, _, rew, done, info = env.step(p, state, torch.ones(3, dtype=torch.int32))
    assert info["truncated"].tolist() == [False, True, False]
    assert info["terminated"].tolist() == [False, False, True]
    assert done.tolist() == [False, True, True] and rew.tolist() == [1.0, 1.0, 1.0]  # the terminating step pays too
    unlimited = p._replace(max_episode_steps=0)
    assert not env.step(unlimited, state._replace(time=torch.full((3,), 10**6, dtype=torch.int32)), torch.zeros(3, dtype=torch.int32))[4]["truncated"].any()


@pytest.mark.parametrize("name", ENVS)
def test_sample_action_and_reset_draws_stay_in_bounds(name):
    env = make_batched_env(name)
    p = env.default_params()
    gen = torch.Generator().manual_seed(0)
    acts = env.sample_action(p, (2, 500), gen)
    space = env.action_space(p)
    if name == "cartpole":
        assert acts.dtype == torch.int32 and acts.shape == (2, 500) and set(acts.unique().tolist()) == {0, 1}
    else:
        assert acts.dtype == torch.float32 and acts.shape == (2, 500, 1)
        assert float(acts.min()) >= space.low[0] and float(acts.max()) <= space.high[0]
    draws = env.reset_draws(p, (500,), gen)
    low, high = (np.asarray(b, np.float32) for b in env.reset_bounds(p))
    assert (draws.numpy() >= low).all() and (draws.numpy() <= high).all()
    state, obs = env.reset(p, draws)
    assert obs.shape == (500, *env.observation_space(p).shape) and state.time.dtype == torch.int32
    # the same generator state draws the same numbers
    again = torch.Generator().manual_seed(0)
    env.sample_action(p, (2, 500), again)
    torch.testing.assert_close(env.reset_draws(p, (500,), again), draws, rtol=0, atol=0)


def test_registry_ids_and_errors():
    from sheeprl_tpu_torch.envs.batched import CartPole, MountainCarContinuous, Pendulum

    assert isinstance(make_batched_env("cartpole"), CartPole) and isinstance(make_batched_env("jax_cartpole"), CartPole)
    assert isinstance(make_batched_env("jax_pendulum"), Pendulum)
    for name in ("mountain_car", "mountain_car_continuous", "jax_mountain_car"):
        assert isinstance(make_batched_env(name), MountainCarContinuous)
    with pytest.raises(ValueError, match="Unknown jax env id"):
        make_batched_env("acrobot")
    with pytest.raises(NotImplementedError, match=r"env\.jax\.env_id"):
        make_batched_env("gymnax:CartPole-v1")
    # the same spaces as the reference's
    for name in ENVS:
        jenv, tenv = make_jax_env(name), make_batched_env(name)
        jo, to = jenv.observation_space(jenv.default_params()), tenv.observation_space(tenv.default_params())
        np.testing.assert_array_equal(jo.low, to.low)
        np.testing.assert_array_equal(jo.high, to.high)


def test_adapter_steps_through_the_port_vector_env():
    """``env=jax_cartpole`` without Anakin: the port's vector env over ``BatchedToGymEnv``;
    each step equals the reference's ``step`` from the state its observation holds."""
    from sheeprl_tpu.envs.jax.cartpole import CartPoleState
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.utils.env import make_vector_env

    cfg = compose(overrides=["exp=ppo", "env=jax_cartpole", "algo.mlp_keys.encoder=[state]", "env.num_envs=3", "env.sync_env=True", "device=cpu"])
    envs = make_vector_env(cfg, cfg.seed, 0, None)
    jenv = make_jax_env("cartpole")
    jp = jenv.default_params()
    try:
        obs, _ = envs.reset(seed=5)
        assert obs["state"].shape == (3, 4) and np.abs(obs["state"]).max() <= 0.05
        rng = np.random.default_rng(0)
        for _ in range(20):
            act = rng.integers(0, 2, 3)
            prev = obs["state"]
            obs, rew, term, trunc, info = envs.step(act)
            for i in range(3):
                if term[i] or trunc[i]:
                    continue
                s = CartPoleState(*(jnp.float32(v) for v in prev[i]), jnp.int32(0))
                _, jobs, jrew, _, jinfo = jenv.step(jp, s, jnp.int32(act[i]), jax.random.PRNGKey(0))
                np.testing.assert_allclose(obs["state"][i], np.asarray(jobs), atol=STEP_ATOL)
                assert rew[i] == float(jrew) and not bool(jinfo["terminated"])
    finally:
        envs.close()
