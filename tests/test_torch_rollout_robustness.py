"""The port's env pool under faults on the CPU (counterpart of
``tests/test_rollout/test_robustness.py``), each run beside the reference's pool on the
same envs and seeds where the reference has the case:

* a hung worker (step timeout 2 s) and a crashed one are restarted: the step that
  restarted them, and the next, equal the reference pool's (the restarted envs report
  ``truncated=True`` and ``info["rollout_restart"]``; the others step on), and the counters
  say which fault it was;
* a restarted group is reset with its seeds plus ``7919 x generation``: its observations
  (a seeded draw) equal the reference pool's after the same restart;
* past ``max_restarts`` the pool tears down and raises ``RolloutAbortError`` with a
  post-mortem of every worker, and the flight recorder holds ``rollout_restart``,
  ``rollout_crash`` and ``rollout_abort``;
* heartbeat ages are finite and fresh;
* the chaos worker fault, crash (exit code 117) and hang, reaches a spawned worker as an
  argument and fires once: its replacement runs clean.
"""

import numpy as np
import pytest

from tests.torch_fault_common import clean_fault_state  # noqa: F401  (an autouse fixture: chaos schedules reset around each test)
from tests.torch_rollout_envs import Thunk
from tests.test_torch_rollout_pool import same_step


class _RefSeededCrashingEnv:
    """The reference's counterpart of ``SeededCrashingEnv`` (its workers fork, so a
    class of this module reaches them)."""

    def __new__(cls, crash_at: int = 0, **kwargs):
        from tests.test_rollout.envs import CrashingEnv

        class Seeded(CrashingEnv):
            def reset(self, seed=None, options=None):
                obs, info = super().reset(seed=seed, options=options)
                obs["state"] = self.np_random.integers(0, 20, size=obs["state"].shape).astype(obs["state"].dtype)
                return obs, info

        return Seeded(crash_at=crash_at, **kwargs)


def pools(ref_fns, port_fns, **kwargs):
    from sheeprl_tpu.rollout import EnvPool as RefPool
    from sheeprl_tpu_torch.rollout.pool import EnvPool

    return RefPool(ref_fns, **kwargs), EnvPool(port_fns, **kwargs)


def test_a_hung_worker_is_restarted_as_the_references(recwarn):
    from tests.test_rollout.envs import HangingEnv

    ref, pool = pools([lambda: HangingEnv(hang_at=2, n_steps=32), lambda: HangingEnv(hang_at=0, n_steps=32)],
                      [Thunk("hanging", stats=False, hang_at=2, n_steps=32), Thunk("hanging", stats=False, hang_at=0, n_steps=32)],
                      num_workers=2, step_timeout_s=2.0, max_restarts=2, restart_backoff_s=0.0)
    try:
        same_step(pool.reset(seed=5), ref.reset(seed=5), info_dtypes=False)
        zeros = np.zeros(2, np.int64)
        same_step(pool.step(zeros), ref.step(zeros))
        out = pool.step(zeros)  # env 0 hangs here
        same_step(out, ref.step(zeros))
        obs, rew, term, trunc, info = out
        assert trunc.tolist() == [True, False] and not term.any() and rew[0] == 0.0
        assert info["rollout_restart"].tolist() == [True, False] and info["_rollout_restart"].tolist() == [True, False]
        assert obs["state"][0, 0] == 0.0 and obs["state"][1, 0] == 2.0
        m = pool.rollout_metrics()
        assert (m["Rollout/worker_restarts"], m["Rollout/worker_timeouts"], m["Rollout/worker_crashes"]) == (1.0, 1.0, 0.0)
        assert sorted(m) == sorted(ref.rollout_metrics())
        out = pool.step(zeros)  # the pool steps on after the restart
        same_step(out, ref.step(zeros))
        assert out[0]["state"][1, 0] == 3.0
    finally:
        pool.close(terminate=True)
        ref.close(terminate=True)


def test_a_crashed_worker_is_restarted_and_reseeded_as_the_references(recwarn):
    ref, pool = pools([lambda: _RefSeededCrashingEnv(crash_at=3, n_steps=32)] * 2,
                      [Thunk("seeded_crashing", stats=False, crash_at=3, n_steps=32)] * 2,
                      num_workers=2, step_timeout_s=30.0, max_restarts=3, restart_backoff_s=0.0)
    try:
        first = pool.reset(seed=7)
        same_step(first, ref.reset(seed=7), info_dtypes=False)
        assert pool._env_seeds == [7, 8]
        zeros = np.zeros(2, np.int64)
        for _ in range(2):
            same_step(pool.step(zeros), ref.step(zeros))
        out = pool.step(zeros)  # both workers crash at their third step
        same_step(out, ref.step(zeros))
        obs, _, term, trunc, info = out
        assert trunc.all() and not term.any() and info["rollout_restart"].all()
        assert [w.generation for w in pool._workers] == [1, 1]
        assert [pool._worker_seeds(w) for w in pool._workers] == [[7 + 7919], [8 + 7919]]
        # the replacements' reset observations: draws of the generation-offset seeds, not of the first reset's
        expected = [np.random.default_rng(s + 7919).integers(0, 20, size=10).astype(np.float32) for s in (7, 8)]
        np.testing.assert_array_equal(obs["state"], np.stack(expected))
        assert not np.array_equal(obs["state"], first[0]["state"])
        m = pool.rollout_metrics()
        assert (m["Rollout/worker_restarts"], m["Rollout/worker_crashes"], m["Rollout/worker_timeouts"]) == (2.0, 2.0, 0.0)
        assert any("exitcode=13" in str(w.message) for w in recwarn.list)
    finally:
        pool.close(terminate=True)
        ref.close(terminate=True)


def test_the_budget_aborts_with_a_post_mortem(recwarn, tmp_path):
    from sheeprl_tpu_torch.obs import flight_recorder
    from sheeprl_tpu_torch.rollout import RolloutAbortError
    from sheeprl_tpu_torch.rollout.pool import EnvPool

    recorder = flight_recorder.FlightRecorder(str(tmp_path))
    previous = flight_recorder.install(recorder)
    try:
        pool = EnvPool([Thunk("crashing", stats=False, crash_at=1, n_steps=32)], num_workers=1, step_timeout_s=30.0, max_restarts=0,
                       restart_backoff_s=0.0)
        pool.reset(seed=0)
        with pytest.raises(RolloutAbortError) as exc_info:
            pool.step(np.zeros(1, np.int64))
    finally:
        flight_recorder.install(previous)
    assert pool.closed and all(w.proc is None or not w.proc.is_alive() for w in pool._workers)
    msg = str(exc_info.value)
    assert "max_restarts=0" in msg and "totals: restarts=1 timeouts=0 crashes=1 over 0 steps" in msg
    assert "worker 0: restarts=0 timeouts=0 crashes=1 last_heartbeat=" in msg
    kinds = [e["kind"] for e in recorder.events()]
    assert [k for k in kinds if k.startswith("rollout_")] == ["rollout_crash", "rollout_restart", "rollout_abort"], kinds


def test_heartbeat_ages_are_fresh():
    from sheeprl_tpu_torch.rollout.pool import EnvPool

    pool = EnvPool([Thunk("hanging", stats=False, n_steps=32)], num_workers=1, step_timeout_s=30.0, heartbeat_interval_s=0.05)
    try:
        pool.reset(seed=0)
        ages = pool.heartbeat_ages()
        assert ages.shape == (1,) and np.isfinite(ages).all() and (ages < 10.0).all()
    finally:
        pool.close(terminate=True)


@pytest.mark.parametrize("mode", ["crash", "hang"])
def test_the_chaos_worker_fault_reaches_a_spawned_worker(recwarn, mode):
    from sheeprl_tpu_torch.fault import chaos
    from sheeprl_tpu_torch.rollout.pool import EnvPool

    chaos.install({"chaos": {"worker_fault_at_step": 2, "worker_fault_mode": mode, "worker_index": 1}})
    pool = EnvPool([Thunk("discrete", stats=False, n_steps=32)] * 4, num_workers=2, step_timeout_s=2.0, max_restarts=1,
                   restart_backoff_s=0.0)
    try:
        assert pool._ctx.get_start_method() == "spawn"
        assert pool._worker_fault == {"at_step": 2, "mode": mode, "worker": 1, "hang_s": 3600.0}
        pool.reset(seed=0)
        zeros = np.zeros(4, np.int64)
        assert not pool.step(zeros)[3].any()
        _, _, _, trunc, info = pool.step(zeros)  # worker 1 (envs 2 and 3) faults at its second step
        assert trunc.tolist() == [False, False, True, True] and info["rollout_restart"].tolist() == [False, False, True, True]
        for _ in range(3):  # the replacement (generation 1) runs clean
            assert not pool.step(zeros)[3].any()
        m = pool.rollout_metrics()
        faults = (1.0, 0.0) if mode == "crash" else (0.0, 1.0)
        assert (m["Rollout/worker_restarts"], m["Rollout/worker_crashes"], m["Rollout/worker_timeouts"]) == (1.0, *faults)
        if mode == "crash":
            assert any(f"exitcode={chaos.WORKER_CRASH_EXIT_CODE}" in str(w.message) for w in recwarn.list)
    finally:
        pool.close(terminate=True)
