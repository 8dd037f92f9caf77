"""The SAC family through the PyTorch port's train and eval entries on the CPU, at tiny
sizes: SAC (synchronous and with the pipelined player at depth 1), DroQ and SAC-AE each
train, checkpoint (the buffer with it), resume from the first checkpoint and evaluate
the last one, with host replay and with ``buffer.device=True`` (the transition ring; a
resume rebuilds it from the checkpointed buffer). Episodes end by a time limit, so the
final-observation correction runs. The same configs go through both packages' config
checks. A config key that asks for what these loops lack raises, naming the key; so do
``sac_decoupled`` and ``ppo_decoupled`` for a ``distributed.mode`` other than ``thread``
and ``sebulba``, naming the modes they run, and the Dreamer loops' refusal of
``rollout.pipeline_depth`` says what their reference does."""

from pathlib import Path

import pytest
import torch

SMALL = ["device=cpu", "env.sync_env=True", "env.num_envs=2", "algo.total_steps=32", "algo.learning_starts=8",
         "checkpoint.every=16", "metric.log_every=16", "env.max_episode_steps=5", "buffer.size=32", "algo.per_rank_batch_size=4"]
RUNS = {
    "sac": ["exp=sac", "algo.hidden_size=8", "env.wrapper.vector_shape=[5]", "env.wrapper.action_dim=2"],
    "droq": ["exp=droq", "algo.hidden_size=8", "algo.replay_ratio=2", "env.wrapper.vector_shape=[5]", "env.wrapper.action_dim=2"],
    "sac_decoupled": ["exp=sac_decoupled", "algo.hidden_size=8", "env.wrapper.vector_shape=[5]", "env.wrapper.action_dim=2"],
    "sac_ae": ["exp=sac_ae", "env.screen_size=16", "env.wrapper.image_size=[3,16,16]", "env.action_repeat=1", "algo.encoder.features_dim=8",
               "algo.encoder.channels=4", "algo.actor.dense_units=8", "algo.critic.dense_units=8"],
}
CASES = {
    "sac_host": [*RUNS["sac"]],
    "sac_device_pipelined": [*RUNS["sac"], "buffer.device=True", "rollout.pipeline_depth=1"],
    "droq_host": [*RUNS["droq"]],
    "droq_device_bf16_store": [*RUNS["droq"], "buffer.device=True", "buffer.store_dtype=bf16"],
    "sac_ae_host": [*RUNS["sac_ae"]],
    "sac_ae_device": [*RUNS["sac_ae"], "buffer.device=True"],
}


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_checkpoint_resume_evaluate(tmp_path, monkeypatch, case):
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import evaluate, run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    ratio = 2 if case.startswith("droq") else 1
    first = run([*CASES[case], *SMALL, f"log_root={tmp_path / 'logs'}"])
    # 16 iterations of 2 envs; the first gradient block at iteration 4 (learning_starts 8 / 2 envs),
    # offset by the 3 prefill iterations: 13 iterations x 2 policy steps x the replay ratio
    assert first.policy_steps == 32 and first.grad_steps == 13 * 2 * ratio and first.test_reward == 0.0
    ckpts = CheckpointManager(Path(first.log_dir) / "checkpoints").list_checkpoints()
    assert [p.name for p in ckpts] == ["ckpt_16", "ckpt_32"]
    state = CheckpointManager.load(ckpts[-1])
    assert state["cumulative_grad_steps"] == first.grad_steps and state["rb"]["full"] and state["rb"]["pos"] == 0
    assert int(state["opt_state"]["critic"]["count"]) == first.grad_steps

    resumed = run([*CASES[case], *SMALL, f"log_root={tmp_path / 'resumed'}", f"checkpoint.resume_from={ckpts[0]}"])
    again = CheckpointManager.load(resumed.checkpoint)
    assert resumed.policy_steps == 32 and resumed.grad_steps > 0 and again["iter_num"] == 16
    # the checkpoint's 5 iterations of steps, then the resumed run's (the governor catches up on the
    # iterations a resume waits out: the same total as the first run's)
    assert int(again["opt_state"]["critic"]["count"]) == again["cumulative_grad_steps"] == 5 * 2 * ratio + resumed.grad_steps == first.grad_steps

    result = evaluate([f"checkpoint_path={ckpts[-1]}", "device=cpu", "env.capture_video=False"])
    assert result.reward == 0.0 and result.steps >= 1


@pytest.mark.parametrize(
    "overrides,refused",
    [
        (["exp=sac"], False),
        (["exp=droq"], False),
        (["exp=sac_ae"], False),
        (["exp=sac", "metric.log_level=2"], True),
        (["exp=sac_ae", "metric.log_level=3"], True),
    ],
)
def test_config_checks_match_the_reference(overrides, refused):
    from tests.test_torch_dv1_cli import check_both

    jax_exc, port_exc = check_both(overrides)
    assert (jax_exc is not None) == (port_exc is not None) == refused, (jax_exc, port_exc)
    if refused:
        assert str(port_exc) == str(jax_exc)


@pytest.mark.parametrize(
    "exp,override,pattern",
    [
        ("sac", "algo.anakin=True", r"algo\.anakin"),
        ("sac", "obs.fleet.dir=fleet", r"obs\.fleet\.dir"),
        ("sac", "+analysis.strict=True", r"analysis\.strict"),
        ("sac", "+fault.autoresume=True", r"fault\.autoresume"),
        ("sac", "+mesh.data=2", r"mesh\.data"),
        ("sac", "buffer.store_dtype=bf16", r"buffer\.store_dtype"),
        ("sac", "algo.precision=fp16", r"algo\.precision"),
        ("sac_decoupled", "+distributed.mode=process", r"distributed\.mode='process': the sac_decoupled loop runs .* placed processes"),
        ("droq", "rollout.pipeline_depth=1", r"pipeline_depth=1: the droq loop acts synchronously, as the reference's does"),
        ("droq", "algo.precision=bf16", r"algo\.precision"),
        ("sac_ae", "rollout.pipeline_depth=2", r"pipeline_depth=2: the sac_ae loop acts synchronously"),
        ("sac_ae", "algo.precision=f32", r"algo\.precision"),
    ],
)
def test_unported_keys_raise_naming_the_key(tmp_path, monkeypatch, exp, override, pattern):
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    with pytest.raises((NotImplementedError, ValueError), match=pattern):
        run([*RUNS[exp], override, *SMALL, f"log_root={tmp_path}"])


@pytest.mark.parametrize(
    "overrides,pattern",
    [
        # the decoupled entries run two threads (the default) or placed processes (sebulba), as the reference's
        (["exp=ppo_decoupled", "+distributed.mode=process"], r"two threads of one process .*thread.* or as placed processes .*sebulba"),
        # DreamerV3's reference reads the key; DreamerV2's and DreamerV1's do not
        (["exp=dreamer_v3_dummy", "env=discrete_dummy", "rollout.pipeline_depth=1"],
         r"reference's dreamer_v3 loop acts through the pipelined player.*acts synchronously and does not use"),
        (["exp=dreamer_v2_dummy", "rollout.pipeline_depth=1"], r"the dreamer_v2 loop acts synchronously, as the reference's does"),
    ],
)
def test_repaired_refusals_state_what_the_reference_does(tmp_path, monkeypatch, overrides, pattern):
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    with pytest.raises(NotImplementedError, match=pattern) as exc:
        run([*overrides, "device=cpu", "env.sync_env=True", f"log_root={tmp_path}"])
    assert "does not have yet" not in str(exc.value) or "pipelined player" not in str(exc.value)


def test_train_entry_asks_for_cuda_by_default(monkeypatch):
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["exp=sac", "env.sync_env=True"])
