"""The Anakin entries of the PyTorch port through the CLI, on the CPU.

* Each of ``exp=ppo_anakin``, ``ppo_anakin_pop``, ``sac_anakin`` and ``sac_anakin_pop``
  trains (at cut total steps, env counts, widths and, for the populations, 3 members),
  resumes from its first checkpoint to the same end, and its last checkpoint evaluates
  through ``sheeprl_tpu_torch.eval`` and loads through ``load_policy`` (a population's:
  member 0's parameters).
* The composed Anakin keys of each exp equal the JAX package's composed config.
* Refusals, each naming its key: ``algo.anakin=True`` on a loop whose reference does not
  read it (``a2c``), ``algo.population.vectorize=True``, a ``gymnax:`` env id, and the
  reference's ``anakin_env`` message on an env that is not batched.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

CUTS = {
    "ppo_anakin": ["algo.rollout_steps=8", "env.num_envs=4", "algo.per_rank_batch_size=8", "algo.update_epochs=1", "algo.total_steps=64",
                   "algo.dense_units=8", "algo.encoder.mlp_features_dim=8"],
    "sac_anakin": ["env.num_envs=4", "algo.hidden_size=16", "algo.per_rank_batch_size=8", "algo.learning_starts=16", "algo.total_steps=64",
                   "algo.anakin_steps_per_dispatch=4", "buffer.size=256"],
}
POP = ["algo.population.size=3"]
COMMON = ["device=cpu", "mesh.precision=32-true", "checkpoint.every=32", "metric.log_every=16", "env.capture_video=False"]


@pytest.fixture(autouse=True)
def quiet(monkeypatch):
    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("exp", ["ppo_anakin", "ppo_anakin_pop", "sac_anakin", "sac_anakin_pop"])
def test_exp_trains_resumes_and_evaluates(tmp_path, exp):
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import _load_checkpoint_cfg, evaluate, run
    from sheeprl_tpu_torch.engine.population import slice_member
    from sheeprl_tpu_torch.parallel.context import RunContext
    from sheeprl_tpu_torch.utils.policy import load_policy

    base = [f"exp={exp}", *CUTS[exp.replace("_pop", "")], *(POP if exp.endswith("_pop") else []), *COMMON]
    first = run([*base, f"log_root={tmp_path / 'first'}"])
    ckpts = CheckpointManager(Path(first.log_dir) / "checkpoints").list_checkpoints()
    assert [p.name for p in ckpts] == ["ckpt_32", "ckpt_64"] and first.policy_steps == 64
    state = CheckpointManager.load(ckpts[-1])
    members = 3 if exp.endswith("_pop") else None
    obs = state["carry"]["obs"]
    assert tuple(obs.shape[: 2 if members else 1]) == ((members, 4) if members else (4,)) and np.isfinite(obs.numpy()).all()
    if exp.startswith("ppo"):
        assert first.grad_steps == 8 and state["update"] == 2
    else:  # 4 prefill iterations, then 12 with one gradient step each
        assert first.grad_steps == 12 and state["iter_num"] == 16
        assert (state["carry"]["gstep"] == 12).all() and (state["carry"]["rows_added"] == 16).all()

    resumed = run([*base, f"log_root={tmp_path / 'resumed'}", f"checkpoint.resume_from={ckpts[0]}", "metric.log_every=8"])
    assert resumed.policy_steps == 64 and resumed.grad_steps == first.grad_steps - 4  # ckpt_32 holds 4 gradient steps
    again = CheckpointManager.load(resumed.checkpoint)
    assert again["policy_step"] == 64

    result = evaluate([f"checkpoint_path={resumed.checkpoint}", "device=cpu", "env.capture_video=False"])
    assert result.steps >= 1 and np.isfinite(result.reward)
    cfg, _ = _load_checkpoint_cfg([f"checkpoint_path={resumed.checkpoint}", "device=cpu"], "checkpoint_path")
    policy = load_policy(RunContext(torch.device("cpu"), 0), cfg, resumed.checkpoint)
    params = again["carry"]["params"]
    if members:
        params = slice_member(params, 0)
    prefix = "" if exp.startswith("ppo") else "actor."  # SAC serves its actor
    for k, v in policy.module.state_dict().items():
        assert torch.equal(v, params[prefix + k]), k
    act = policy.act_fn(policy.params, policy.obs_tensors(policy.zero_obs(2)))
    assert act.shape[0] == 2


@pytest.mark.parametrize("exp", ["ppo_anakin", "ppo_anakin_pop", "sac_anakin", "sac_anakin_pop"])
def test_composed_anakin_keys_equal_the_reference(exp):
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.config.core import compose

    j, t = jax_compose(overrides=[f"exp={exp}"]), compose(overrides=[f"exp={exp}"])
    for key in ("anakin", "anakin_steps_per_dispatch", "population", "total_steps", "rollout_steps", "per_rank_batch_size",
                "update_epochs", "learning_starts", "replay_ratio", "mlp_keys", "cnn_keys", "name"):
        assert t.algo.get(key) == j.algo.get(key), key
    assert t.env.jax == j.env.jax and t.env.num_envs == j.env.num_envs and t.env.id == j.env.id
    assert t.buffer.size == j.buffer.size and t.buffer.memmap == j.buffer.memmap
    assert t.env.wrapper._target_ == "sheeprl_tpu_torch.envs.batched.gym_adapter.BatchedToGymEnv"
    for env in ("jax_cartpole", "jax_pendulum", "jax_mountain_car"):
        je, te = jax_compose(overrides=["exp=ppo", f"env={env}"]).env, compose(overrides=["exp=ppo", f"env={env}"]).env
        assert te.jax == je.jax and te.wrapper.env_id == je.wrapper.env_id and te.id == je.id


@pytest.mark.parametrize(
    "overrides,key",
    [
        (["exp=a2c", "env=jax_cartpole", "algo.mlp_keys.encoder=[state]", "algo.anakin=True"], "algo.anakin"),
        (["exp=ppo_anakin", *CUTS["ppo_anakin"], "algo.population.size=2", "algo.population.vectorize=True"], "algo.population.vectorize"),
        (["exp=sac_anakin", *CUTS["sac_anakin"], "algo.population.size=2", "algo.population.vectorize=True"], "algo.population.vectorize"),
        (["exp=ppo_anakin", *CUTS["ppo_anakin"], "env.jax.env_id=gymnax:CartPole-v1"], "env.jax.env_id"),
        (["exp=ppo", "env=discrete_dummy", "algo.mlp_keys.encoder=[state]", "algo.anakin=True"], "algo.anakin"),
        (["exp=ppo_anakin", *CUTS["ppo_anakin"], "obs.fleet.dir=fleet"], "obs.fleet.dir"),
        (["exp=sac_anakin", *CUTS["sac_anakin"], "chaos.worker_fault_at_step=3"], "chaos.worker_fault_at_step"),
    ],
)
def test_refusals_name_their_key(tmp_path, overrides, key):
    from sheeprl_tpu_torch.cli import run

    with pytest.raises((NotImplementedError, ValueError), match=key.replace(".", r"\.")):
        run([*overrides, "device=cpu", "dry_run=True", "algo.run_test=False", f"log_root={tmp_path}"])


@pytest.mark.parametrize("exp", ["ppo_anakin", "sac_anakin"])
def test_the_engine_runs_with_the_training_monitor(tmp_path, exp):
    """``obs.enabled=True`` (refused before the monitor was ported): the run writes its
    span trace and its cost models under the reference's dispatch names, and logs the
    step's ``Health/*``."""
    import json

    from sheeprl_tpu_torch.cli import run

    result = run([f"exp={exp}", *CUTS[exp], *COMMON, "obs.enabled=True", "algo.run_test=False", f"log_root={tmp_path}"])
    log_dir = Path(result.log_dir)
    spans = {e["name"] for e in json.loads((log_dir / "trace.json").read_text())["traceEvents"] if e["ph"] == "X"}
    assert {"Time/update", "Time/phase_dispatch", "Time/train_time"} <= spans
    models = json.loads((log_dir / "perf_report.json").read_text())["cost_models"]
    assert any(name.startswith(f"anakin/{exp[:3]}_dispatch") and m["flops"] > 0 for name, m in models.items()), models


def test_host_loop_runs_the_batched_env_through_the_adapter(tmp_path):
    """Without ``algo.anakin`` the same env runs through the host PPO loop (its vector env
    over ``BatchedToGymEnv``) and its greedy test episode."""
    from sheeprl_tpu_torch.cli import run

    result = run(["exp=ppo", "env=jax_cartpole", "algo.mlp_keys.encoder=[state]", "env.num_envs=2", "env.sync_env=True",
                  "algo.rollout_steps=8", "algo.per_rank_batch_size=8", "algo.update_epochs=1", "algo.total_steps=32", *COMMON,
                  f"log_root={tmp_path}"])
    assert result.policy_steps == 32 and result.grad_steps == 4 and result.test_reward >= 1.0
