"""The PPO family through the PyTorch port's train and eval entries on the CPU, at tiny
sizes: PPO (``exp=ppo_dummy``, synchronous and with the pipelined player at depth 1),
A2C and recurrent PPO (LSTM and attention) each train, checkpoint, resume from a
checkpoint and evaluate the last one; episodes are cut by a time limit, so the
truncation bootstrap runs. A config key that asks for what these loops lack raises,
naming the key."""

from pathlib import Path

import pytest
import torch

SMALL = ["device=cpu", "env.sync_env=True", "env.num_envs=2", "algo.rollout_steps=8", "algo.total_steps=64",
         "checkpoint.every=32", "metric.log_every=16", "env.max_episode_steps=3"]
RUNS = {
    "ppo": ["exp=ppo_dummy", "algo.per_rank_batch_size=8", "algo.update_epochs=2", "algo.anneal_lr=True"],
    "ppo_pipelined": ["exp=ppo_dummy", "algo.per_rank_batch_size=8", "algo.update_epochs=2", "rollout.pipeline_depth=1"],
    "a2c": ["exp=a2c", "env=continuous_dummy", "algo.mlp_keys.encoder=[state]"],
    "ppo_recurrent": ["exp=ppo_recurrent", "env=discrete_dummy", "algo.mlp_keys.encoder=[state]", "algo.per_rank_num_batches=2", "algo.update_epochs=2"],
    "ppo_recurrent_attention": ["exp=ppo_recurrent", "env=discrete_dummy", "algo.mlp_keys.encoder=[state]", "algo.per_rank_num_batches=2",
                                "algo.update_epochs=2", "algo.sequence_model=attention", "algo.attention.window=4"],
}


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_train_checkpoint_resume_evaluate(tmp_path, monkeypatch, name):
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import evaluate, run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    overrides = [*RUNS[name], *SMALL, f"log_root={tmp_path / 'logs'}"]
    first = run(overrides)
    per_update = {"a2c": 1, "ppo_recurrent": 4, "ppo_recurrent_attention": 4}.get(name, 4)  # epochs x minibatches
    assert first.policy_steps == 64 and first.grad_steps == 4 * per_update and first.test_reward == 0.0
    ckpts = CheckpointManager(Path(first.log_dir) / "checkpoints").list_checkpoints()
    assert [p.name for p in ckpts] == ["ckpt_32", "ckpt_64"]
    state = CheckpointManager.load(ckpts[-1])
    assert state["update"] == 4 and int(state["opt_state"]["count"]) == first.grad_steps

    resumed = run([*RUNS[name], *SMALL, f"log_root={tmp_path / 'resumed'}", f"checkpoint.resume_from={ckpts[0]}"])
    assert resumed.policy_steps == 64 and resumed.grad_steps == 2 * per_update
    again = CheckpointManager.load(resumed.checkpoint)
    assert int(again["opt_state"]["count"]) == first.grad_steps and again["update"] == 4

    result = evaluate([f"checkpoint_path={ckpts[-1]}", "device=cpu", "env.capture_video=False"])
    assert result.reward == 0.0 and result.steps >= 1


@pytest.mark.parametrize(
    "exp,override,key",
    [
        ("ppo_dummy", "algo.anakin=True", "algo.anakin"),
        ("ppo_dummy", "+env.pool.enabled=True", "env.pool.enabled"),
        ("ppo_dummy", "+obs.enabled=True", "obs.enabled"),
        ("ppo_dummy", "+analysis.strict=True", "analysis.strict"),
        ("ppo_dummy", "+fault.autoresume=True", "fault.autoresume"),
        ("ppo_dummy", "+mesh.sequence=2", "mesh.sequence"),
        ("ppo_dummy", "buffer.memmap=True", "buffer.memmap"),
        ("ppo_dummy", "algo.precision=fp16", "algo.precision"),
        ("ppo_decoupled", "+distributed.mode=sebulba", "distributed.mode"),
        ("a2c", "rollout.pipeline_depth=1", "rollout.pipeline_depth"),
        ("ppo_recurrent", "rollout.pipeline_depth=2", "rollout.pipeline_depth"),
        ("ppo_recurrent", "algo.precision=bf16", "algo.precision"),
    ],
)
def test_unported_keys_raise_naming_the_key(tmp_path, monkeypatch, exp, override, key):
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    env = [] if exp == "ppo_dummy" else ["env=discrete_dummy", "algo.mlp_keys.encoder=[state]"]
    with pytest.raises((NotImplementedError, ValueError), match=key.replace(".", r"\.")):
        run([f"exp={exp}", *env, override, *SMALL, f"log_root={tmp_path}"])


def test_train_entry_asks_for_cuda_by_default(monkeypatch):
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["exp=ppo_dummy", "env.sync_env=True"])
