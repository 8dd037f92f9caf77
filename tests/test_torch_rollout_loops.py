"""Every host loop of the port with the env pool and the chaos worker fault on the CPU, at
tiny sizes: ``env.pool.enabled=True`` (2 workers over 2 envs) and
``chaos.worker_fault_at_step=3`` crash worker 1, which the pool restarts (exit code 117
in its warning); the run then ends at its policy steps. Each loop logs ``Rollout/*``
where its reference does (the Dreamer loop for DreamerV1 and V2, not for P2E; SAC and
SAC-AE, not DroQ; PPO, not A2C, recurrent PPO or the decoupled entries), with the
restart counted. DreamerV3 and PPO run in ``test_torch_rollout_dv3.py`` and
``test_torch_rollout_cli.py`` against the reference's runs.
"""

import pytest
import torch

from tests.torch_fault_common import Recorder, clean_fault_state  # noqa: F401  (an autouse fixture)

POOL = ["device=cpu", "env.num_envs=2", "env.pool.enabled=True", "env.pool.num_workers=2", "chaos.worker_fault_at_step=3",
        "chaos.worker_fault_mode=crash", "chaos.worker_index=1", "rollout.restart_backoff_s=0", "algo.run_test=False",
        "checkpoint.every=0", "checkpoint.save_last=False"]
_SAC = ["algo.learning_starts=8", "metric.log_every=16", "env.max_episode_steps=5", "buffer.size=32", "algo.per_rank_batch_size=4",
        "env.wrapper.vector_shape=[5]", "env.wrapper.action_dim=2", "algo.hidden_size=8"]
_PPO = ["algo.rollout_steps=8", "metric.log_every=16", "env.max_episode_steps=3", "env=discrete_dummy", "algo.mlp_keys.encoder=[state]"]
# name: (overrides, total policy steps, whether its reference logs Rollout/*)
LOOPS = {
    "dreamer_v1": (["exp=dreamer_v1_dummy", "algo.total_steps=48", "metric.log_every=24"], 48, True),
    "dreamer_v2": (["exp=dreamer_v2_dummy", "env.wrapper.n_steps=10", "algo.total_steps=48", "algo.learning_starts=32",
                    "metric.log_every=24"], 48, True),
    "p2e_dv2": (["exp=p2e_dv2_dummy", "algo.total_steps=48", "metric.log_every=24"], 48, False),
    "a2c": (["exp=a2c", *_PPO, "algo.total_steps=32"], 32, False),
    "ppo_recurrent": (["exp=ppo_recurrent", *_PPO, "algo.per_rank_num_batches=2", "algo.total_steps=32"], 32, False),
    "ppo_decoupled": (["exp=ppo_decoupled", *_PPO, "algo.per_rank_batch_size=8", "algo.dense_units=8", "algo.mlp_layers=1",
                       "algo.total_steps=32"], 32, False),
    "sac": (["exp=sac", *_SAC, "algo.total_steps=32", "rollout.pipeline_depth=1"], 32, True),
    "droq": (["exp=droq", *_SAC, "algo.total_steps=32"], 32, False),
    "sac_ae": (["exp=sac_ae", "algo.learning_starts=8", "metric.log_every=16", "env.max_episode_steps=5", "buffer.size=32",
                "algo.per_rank_batch_size=4", "env.screen_size=16", "env.wrapper.image_size=[3,16,16]", "env.action_repeat=1",
                "algo.encoder.features_dim=8", "algo.encoder.channels=4", "algo.actor.dense_units=8", "algo.critic.dense_units=8",
                "algo.total_steps=32"], 32, True),
    "sac_decoupled": (["exp=sac_decoupled", *_SAC, "algo.total_steps=32"], 32, False),
}


@pytest.fixture(autouse=True)
def few_threads(monkeypatch):
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    yield
    torch.set_num_threads(before)


@pytest.fixture
def log(monkeypatch):
    """Every loop logs into one ``Recorder``."""
    import sheeprl_tpu_torch.algos.dreamer_loop as dreamer_loop
    import sheeprl_tpu_torch.algos.ppo.ppo as ppo
    import sheeprl_tpu_torch.algos.sac.sac as sac
    import sheeprl_tpu_torch.algos.sac.sac_decoupled as sac_decoupled

    rec = Recorder()
    for mod in (dreamer_loop, ppo, sac, sac_decoupled):
        monkeypatch.setattr(mod, "get_logger", lambda cfg, log_dir: rec)
    return rec


@pytest.mark.parametrize("loop", list(LOOPS))
def test_the_loop_runs_on_the_pool_through_a_worker_crash(tmp_path, log, recwarn, loop):
    from sheeprl_tpu_torch.cli import run

    overrides, steps, merges = LOOPS[loop]
    result = run([*overrides, *POOL, f"log_root={tmp_path}"])
    assert result.policy_steps == steps
    restarts = [str(w.message) for w in recwarn.list if "EnvPool restarting worker" in str(w.message)]
    assert len(restarts) == 1 and "worker 1" in restarts[0] and "exitcode=117" in restarts[0], restarts
    rollout = [{k: v for k, v in m.items() if k.startswith("Rollout/")} for _, m in log.logged if "Test/cumulative_reward" not in m]
    assert rollout and all(bool(r) == merges for r in rollout), (loop, rollout)
    if merges:
        last = rollout[-1]
        assert (last["Rollout/worker_restarts"], last["Rollout/worker_crashes"], last["Rollout/num_workers"]) == (1.0, 1.0, 2.0)
        assert last["Rollout/env_steps"] == steps // 2
