"""The port's env pool (``sheeprl_tpu_torch/rollout/pool.py``) on the CPU, at the dummy
envs' sizes.

* Parity: built by both packages' ``make_vector_env`` with ``env.pool.enabled=True`` on
  the same seeds, the port's pool (spawned workers) equals the reference's (forked
  workers, gymnasium's envs) and the port's ``SyncVectorEnv`` bit for bit over steps that
  cross episode ends: observations and their dtypes, float64 rewards, the bool flags, and
  the infos (``final_obs``, ``final_info``, the episode statistics but for their wall
  time, every mask; the infos' dtypes against the sync env's, ``same_info``), for the
  three dummy envs and a dict of pixels and a vector.
* Behaviour: ``reset(seed=s)`` seeds env ``i`` with ``s + i``; returned observations do
  not alias the slab; 7 envs on 3 workers make contiguous groups of 3, 2 and 2; ``close``
  ends every worker and is idempotent; ``rollout_metrics``'s keys are the reference's and
  a plain vector env gives ``{}``; the slab layouts and batched spaces are gymnasium's;
  ``fork`` is refused by name; a pool that cannot start (a thunk that does not pickle, an
  env that raises while it is built) raises and leaves no worker.
* Isolation: ``rollout.worker`` and ``rollout.shared`` load no torch in a fresh
  interpreter, and a worker loads neither torch, JAX nor the JAX package, and initialises
  no CUDA.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_dv3_agent import compose_pair
from tests.torch_fault_common import clean_fault_state  # noqa: F401  (an autouse fixture: no chaos schedule leaks in)
from tests.torch_rollout_envs import thunks, worker_report

REPO = Path(__file__).resolve().parent.parent
N_STEPS = 4  # episode length: 11 steps cross two resets


def same_info(port, ref, info_dtypes: bool, path="info"):
    """Batched infos equal, recursively: keys, masks and values, with their dtypes where
    ``info_dtypes`` (the port's ``RecordEpisodeStatistics`` keeps ``r`` float32 and ``l``
    int32 where gymnasium's batch float64 and int64: the pool is held to the reference's
    values, and to the port's sync env's dtypes too); the episode statistics' wall time
    ``t`` left out. Observations inside ``final_obs`` always keep their dtype."""
    assert sorted(port) == sorted(ref), (path, sorted(port), sorted(ref))
    for k in ref:
        if k in ("t", "_t") and path.endswith("episode"):
            continue
        p, r = port[k], ref[k]
        if k == "final_obs":
            for a, b in zip(p, r):
                assert (a is None) == (b is None), path
                if b is not None:
                    assert sorted(a) == sorted(b)
                    for kk in b:
                        assert np.asarray(a[kk]).dtype == np.asarray(b[kk]).dtype
                        np.testing.assert_array_equal(a[kk], b[kk])
        elif isinstance(r, dict):
            same_info(p, r, info_dtypes, f"{path}.{k}")
        else:
            if info_dtypes or k.startswith("_"):
                assert np.asarray(p).dtype == np.asarray(r).dtype, (path, k, np.asarray(p).dtype, np.asarray(r).dtype)
            np.testing.assert_array_equal(p, r, err_msg=f"{path}.{k}")


def same_step(port, ref, info_dtypes: bool = True):
    obs_p, obs_r = port[0], ref[0]
    assert sorted(obs_p) == sorted(obs_r)
    for k in obs_r:
        assert obs_p[k].dtype == obs_r[k].dtype, k
        np.testing.assert_array_equal(obs_p[k], obs_r[k], err_msg=k)
    for a, b in zip(port[1:-1], ref[1:-1]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    same_info(port[-1], ref[-1], info_dtypes)


def actions_for(space, rng, n):
    name = type(space).__name__
    if name == "Discrete":
        return rng.integers(0, space.n, size=n)
    if name == "MultiDiscrete":
        return np.stack([rng.integers(0, space.nvec) for _ in range(n)])
    return rng.uniform(-1, 1, size=(n, *space.shape)).astype(np.float32)


CASES = {
    "discrete": ["env=discrete_dummy", "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]"],
    "multidiscrete": ["env=multidiscrete_dummy", "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]"],
    "continuous": ["env=continuous_dummy", "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]"],
    "pixels_and_vector": ["env=discrete_dummy", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_pool_equals_the_references_pool_and_the_sync_vector_env(case):
    from sheeprl_tpu.utils.env import make_vector_env as ref_make_vector_env
    from sheeprl_tpu_torch.envs.vector import SyncVectorEnv
    from sheeprl_tpu_torch.rollout.pool import EnvPool
    from sheeprl_tpu_torch.utils.env import make_vector_env

    extra = [*CASES[case], f"env.wrapper.n_steps={N_STEPS}", "env.num_envs=3", "env.pool.enabled=True", "env.pool.num_workers=2",
             "env.sync_env=True", "rollout.step_timeout_s=30"]
    rcfg, pcfg = compose_pair(extra)
    ref, pool = ref_make_vector_env(rcfg, 7, 0), make_vector_env(pcfg, 7, 0)
    pcfg.env.pool.enabled = False
    sync = make_vector_env(pcfg, 7, 0)
    try:
        assert isinstance(pool, EnvPool) and isinstance(sync, SyncVectorEnv) and type(ref).__name__ == "EnvPool"
        assert pool.num_workers == 2 and [w.num_envs for w in pool._workers] == [2, 1]
        out = {"ref": ref.reset(seed=7), "pool": pool.reset(seed=7), "sync": sync.reset(seed=7)}
        same_step(out["pool"], out["ref"], info_dtypes=False)
        same_step(out["pool"], out["sync"])
        rng = np.random.default_rng(0)
        ends = 0
        for _ in range(11):
            actions = actions_for(ref.single_action_space, rng, 3)
            out = {name: env.step(actions.copy()) for name, env in (("ref", ref), ("pool", pool), ("sync", sync))}
            same_step(out["pool"], out["ref"], info_dtypes=False)
            same_step(out["pool"], out["sync"])
            ends += "final_obs" in out["ref"][-1]
            assert out["pool"][1].dtype == np.float64 and out["pool"][2].dtype == np.bool_
        assert ends == 2
        assert pool.rollout_metrics()["Rollout/env_steps"] == 11.0
    finally:
        for env in (ref, pool, sync):
            env.close()


@pytest.fixture(scope="module")
def pool3():
    """A pool of 3 probe envs (discrete dummies that report their process and a seeded
    draw) on 3 workers, shared by the behaviour tests."""
    from sheeprl_tpu_torch.rollout.pool import EnvPool

    pool = EnvPool(thunks("probe", 3, n_steps=16), num_workers=3, step_timeout_s=30.0)
    yield pool
    pool.close()


def test_reset_seeds_env_i_with_s_plus_i(pool3):
    from sheeprl_tpu_torch.envs.vector import SyncVectorEnv

    sync = SyncVectorEnv(thunks("probe", 3, n_steps=16))
    for seed in (0, 42):
        so, sinfo = sync.reset(seed=seed)
        po, pinfo = pool3.reset(seed=seed)
        assert pool3._env_seeds == [seed, seed + 1, seed + 2]
        assert pinfo["draw"].tolist() == sinfo["draw"].tolist() == [
            int(np.random.default_rng(seed + i).integers(1 << 30)) for i in range(3)]
        for k in so:
            np.testing.assert_array_equal(so[k], po[k])
    sync.close()


def test_observations_are_snapshots(pool3):
    obs0, _ = pool3.reset(seed=0)
    kept = {k: v.copy() for k, v in obs0.items()}
    obs1, *_ = pool3.step(np.zeros(3, dtype=np.int64))
    for k in kept:
        np.testing.assert_array_equal(obs0[k], kept[k])
        assert not np.shares_memory(obs1[k], pool3._views.obs[k])
    assert (obs1["state"] != obs0["state"]).any()


def test_metrics_keys_are_the_references(pool3):
    from sheeprl_tpu.rollout import EnvPool as RefPool
    from sheeprl_tpu.envs.dummy import DiscreteDummyEnv as RefDummy

    ref = RefPool([RefDummy, RefDummy], num_workers=2, step_timeout_s=30.0)
    try:
        ref.reset(seed=0)
        ref.step(np.zeros(2, np.int64))
        pool3.reset(seed=0)
        pool3.step(np.zeros(3, np.int64))
        assert sorted(pool3.rollout_metrics()) == sorted(ref.rollout_metrics())
        m = pool3.rollout_metrics()
        assert m["Rollout/env_steps"] >= 1.0 and m["Rollout/num_workers"] == 3.0 and m["Rollout/worker_restarts"] == 0.0
        assert 0.0 <= m["Rollout/heartbeat_age_max"] < 10.0
    finally:
        ref.close()


SPACES = {
    "box": lambda m: m.Box(-1.0, 2.0, (2, 3), np.float32),
    "discrete": lambda m: m.Discrete(5),
    "multidiscrete": lambda m: m.MultiDiscrete([2, 3, 4]),
    "dict": lambda m: m.Dict({"rgb": m.Box(0, 255, (3, 8, 8), np.uint8), "state": m.Box(-20, 20, (4,), np.float32)}),
}


@pytest.mark.parametrize("space", list(SPACES))
def test_slab_layouts_and_batched_spaces_are_gymnasiums(space):
    """``create_empty_array`` and ``batch_space`` of the port's spaces give gymnasium's
    layouts and spaces over 3 envs."""
    import gymnasium as gym
    from gymnasium.vector.utils import batch_space as gym_batch, create_empty_array as gym_empty

    from sheeprl_tpu_torch.envs import spaces
    from tests.test_torch_envs import _same_space

    port, ref = SPACES[space](spaces), SPACES[space](gym.spaces)
    empty, ref_empty = spaces.create_empty_array(port, 3), gym_empty(ref, 3, fn=np.zeros)
    pairs = [(empty[k], ref_empty[k]) for k in ref_empty] if space == "dict" else [(empty, ref_empty)]
    assert (sorted(empty) == sorted(ref_empty)) if space == "dict" else True
    for a, b in pairs:
        assert a.shape == b.shape and a.dtype == b.dtype and not a.any()
    batched, ref_batched = spaces.batch_space(port, 3), gym_batch(ref, 3)
    _same_space(batched, ref_batched)
    if space == "discrete":
        assert batched.nvec.tolist() == ref_batched.nvec.tolist()


def test_batched_spaces_are_gymnasiums(pool3):
    from gymnasium.vector.utils import batch_space

    from tests.test_torch_envs import _same_space
    import gymnasium as gym

    ref_single = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8), "state": gym.spaces.Box(-20, 20, (10,), np.float32)})
    _same_space(pool3.observation_space, batch_space(ref_single, 3))
    assert type(pool3.action_space).__name__ == "MultiDiscrete" and pool3.action_space.nvec.tolist() == [2, 2, 2]


def test_seven_envs_on_three_workers_and_close():
    from sheeprl_tpu_torch.rollout.pool import EnvPool

    pool = EnvPool(thunks("discrete", 7, n_steps=4), num_workers=3, step_timeout_s=30.0)
    assert [(w.first, w.num_envs) for w in pool._workers] == [(0, 3), (3, 2), (5, 2)]
    obs, _ = pool.reset(seed=3)
    assert obs["state"].shape == (7, 10)
    procs = [w.proc for w in pool._workers]
    assert all(p.is_alive() for p in procs)
    pool.close()
    assert all(not p.is_alive() for p in procs) and pool.closed
    pool.close()  # idempotent


def test_rollout_metrics_is_a_noop_for_a_plain_vector_env():
    from sheeprl_tpu_torch.envs.vector import SyncVectorEnv
    from sheeprl_tpu_torch.rollout import rollout_metrics

    sync = SyncVectorEnv(thunks("discrete", 2))
    assert rollout_metrics(sync) == {}


def test_fork_is_refused_by_name():
    from sheeprl_tpu_torch.rollout.pool import EnvPool

    with pytest.raises(ValueError, match=r"start_method='fork'.*never 'fork'.*CUDA context"):
        EnvPool(thunks("discrete", 2), start_method="fork")


def test_a_pool_that_cannot_start_raises_and_leaves_no_worker():
    """A thunk that does not pickle (spawn ships it), and a worker whose env raises while
    it is built: the constructor raises, and every worker it started is gone."""
    import multiprocessing as mp

    from sheeprl_tpu_torch.rollout.pool import EnvPool
    from tests.torch_rollout_envs import Thunk

    before = set(mp.active_children())
    with pytest.raises(AttributeError, match="local object"):
        EnvPool([*thunks("discrete", 1), lambda: None], num_workers=2)
    with pytest.raises(RuntimeError, match="worker 1 failed to start.*raised"):
        EnvPool([*thunks("discrete", 1), Thunk("no_such_env")], num_workers=2,
                observation_space=thunks("discrete", 1)[0]().observation_space, action_space=thunks("discrete", 1)[0]().action_space)
    assert not [p for p in mp.active_children() if p not in before and p.is_alive()]


def test_worker_modules_load_no_torch_in_a_fresh_interpreter():
    code = ("import sys\nimport sheeprl_tpu_torch.rollout.worker, sheeprl_tpu_torch.rollout.shared\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'gymnasium', 'sheeprl_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_a_worker_loads_no_torch_nor_jax_and_initialises_no_cuda(pool3):
    _, info = pool3.reset(seed=0)
    report = worker_report(info)
    assert not report["jax_loaded"] and not report["reference_loaded"] and not report["cuda_initialized"], report
    # a spawned worker imports the training process's main module (pytest's here) and
    # what its arguments need: no torch at all
    assert not report["torch_loaded"], report
