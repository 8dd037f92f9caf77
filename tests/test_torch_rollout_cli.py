"""The env pool through the port's entries on the CPU, at tiny sizes.

* PPO with ``env.pool.enabled=True`` and ``rollout.pipeline_depth=1`` beside the
  reference's (``tests/test_rollout/test_cli_pool.py``'s overrides, run for two updates
  with a checkpoint each instead of its dry run): the same policy steps, checkpoint names
  and logged metric names, ``Rollout/*`` among them, with the pool's counts.
* With the chaos crash and ``rollout.max_restarts=0`` the pool's ``RolloutAbortError``
  escapes the entry like any crash: it leaves a blackbox holding ``rollout_crash``,
  ``rollout_restart`` and ``rollout_abort``, and ``python -m sheeprl_tpu_torch`` exits
  non-zero.
* ``sac_decoupled`` under Sebulba with the pool: 2 actors, each on its share of
  ``env.pool.num_workers=3`` (2 and 1, as ``shard_pool_cfg`` splits it), its ``Rollout/*``
  in the learner's summary.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests.torch_fault_common import Recorder, clean_fault_state  # noqa: F401  (an autouse fixture)
from tests.torch_sebulba_common import KILL_SAC, PORT_CPU, QUIET_LOG, Run, child_env, run_ok, summary

REPO = Path(__file__).resolve().parent.parent
# tests/test_rollout/test_cli_pool.py's overrides, for two updates with a checkpoint each
PPO_POOL = ["exp=ppo", "env=discrete_dummy", "algo.mlp_keys.encoder=[state]", "algo.rollout_steps=8", "algo.per_rank_batch_size=8",
            "algo.update_epochs=1", "algo.dense_units=8", "algo.mlp_layers=1", "algo.encoder.mlp_features_dim=8", "env.pool.enabled=True",
            "env.pool.num_workers=2", "rollout.pipeline_depth=1", "rollout.step_timeout_s=60", "env.num_envs=2",
            "env.capture_video=False", "metric.log_every=1", "buffer.memmap=False", "algo.total_steps=32", "checkpoint.every=16",
            "checkpoint.save_last=True", "algo.run_test=False"]
ROLLOUT_KEYS = {"Rollout/worker_restarts", "Rollout/worker_timeouts", "Rollout/worker_crashes", "Rollout/env_steps",
                "Rollout/num_workers", "Rollout/heartbeat_age_max"}


@pytest.fixture(autouse=True)
def few_threads(monkeypatch):
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    yield
    torch.set_num_threads(before)


def ckpt_names(root: Path):
    return sorted(p.name for p in root.rglob("checkpoints/ckpt_*"))


def test_ppo_with_the_pool_and_the_pipeline_matches_the_reference(tmp_path, monkeypatch):
    import sheeprl_tpu.algos.ppo.ppo as jax_ppo
    import sheeprl_tpu_torch.algos.ppo.ppo as ppo
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu_torch.cli import run

    logs = {"jax": Recorder(), "port": Recorder()}
    monkeypatch.setattr(jax_ppo, "get_logger", lambda cfg, log_dir: logs["jax"])
    monkeypatch.setattr(ppo, "get_logger", lambda cfg, log_dir: logs["port"])
    jax_run([*PPO_POOL, f"log_root={tmp_path / 'jax'}"])
    result = run([*PPO_POOL, "device=cpu", f"log_root={tmp_path / 'port'}"])
    assert result.policy_steps == 32 and result.grad_steps == 4  # 2 updates of 2 minibatches
    assert ckpt_names(tmp_path / "port") == ckpt_names(tmp_path / "jax") == ["ckpt_16", "ckpt_32"]
    names = {k: [sorted(m) for _, m in log.logged] for k, log in logs.items()}
    assert names["port"] == names["jax"] and all(ROLLOUT_KEYS <= set(n) for n in names["port"])
    last = logs["port"].logged[-1][1]
    assert last["Rollout/env_steps"] == 16.0 and last["Rollout/num_workers"] == 2.0 and last["Rollout/worker_restarts"] == 0.0
    assert [step for step, _ in logs["port"].logged] == [step for step, _ in logs["jax"].logged]


ABORT = [*PPO_POOL, "rollout.pipeline_depth=0", "chaos.worker_fault_at_step=3", "chaos.worker_fault_mode=crash", "chaos.worker_index=1",
         "rollout.max_restarts=0", "rollout.restart_backoff_s=0", "metric.log_level=0", "device=cpu"]


def test_a_spent_restart_budget_escapes_the_entry_with_a_blackbox(tmp_path):
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.rollout import RolloutAbortError

    with pytest.raises(RolloutAbortError, match=r"max_restarts=0 \(last failure: worker 1: worker 1 pipe closed .*exitcode=117"):
        run([*ABORT, f"log_root={tmp_path}"])
    box = next(tmp_path.rglob("blackbox"))
    kinds = [json.loads(line)["kind"] for line in (box / "events.jsonl").read_text().splitlines()]
    assert [k for k in kinds if k.startswith("rollout_")] == ["rollout_crash", "rollout_restart", "rollout_abort"], kinds
    assert (box / "meta.json").is_file()


def test_the_module_entry_exits_nonzero_on_a_spent_budget(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "sheeprl_tpu_torch", *ABORT, f"log_root={tmp_path}"], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=child_env())
    assert proc.returncode != 0 and "RolloutAbortError" in proc.stderr, proc.stderr[-3000:]
    events = next(tmp_path.rglob("blackbox/events.jsonl")).read_text()
    assert '"kind": "rollout_abort"' in events, events[-2000:]


def test_sebulba_actors_each_run_their_share_of_the_pool(tmp_path):
    overrides = [o for o in KILL_SAC if not o.startswith("chaos.")]
    overrides = [*[o for o in overrides if not o.startswith(("algo.total_steps", "checkpoint.every"))], "algo.total_steps=64",
                 "checkpoint.every=0", "env.pool.enabled=True", "env.pool.num_workers=3", *PORT_CPU, *QUIET_LOG, f"log_root={tmp_path}"]
    run_ok([Run("sheeprl_tpu_torch.sebulba", overrides, child_env(SHEEPRL_TPU_SEBULBA_SUMMARY=tmp_path / "summary.json"))], timeout=180)
    s = summary(tmp_path / "summary.json")
    assert s["error"] is None and sorted(s["actors"]) == ["0_g0", "1_g0"]
    rollout = {k: a["rollout"] for k, a in s["actors"].items()}
    assert {k: r["Rollout/num_workers"] for k, r in rollout.items()} == {"0_g0": 2.0, "1_g0": 1.0}
    # 64 policy steps over 2 actors of 2 envs: 16 steps an actor's pool
    assert all(r["Rollout/env_steps"] == 16.0 and r["Rollout/worker_restarts"] == 0.0 for r in rollout.values()), rollout
    assert s["env_steps_total"] == 64
