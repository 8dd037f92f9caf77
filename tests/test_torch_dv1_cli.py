"""DreamerV1 through the PyTorch port's train and eval entries on the CPU, at the
``dreamer_v1_dummy`` exp's tiny size: it trains (the replay mirrored in the device ring,
``buffer.device=True``), checkpoints, resumes from a checkpoint and evaluates the last
one; without ``device=cpu`` the entry asks for CUDA and raises. And the config checks
that the port shares with the JAX package's CLI (``cli.py::check_configs``): both refuse
pixel observations for DreamerV1, DreamerV2 and their P2E variants unless one 64 x 64
frame, and both take a P2E finetuning run that loads the exploration buffer as
prefilled."""

from pathlib import Path

import pytest
import torch

RUN = [
    "exp=dreamer_v1_dummy",
    "device=cpu",
    "env.sync_env=True",
    "algo.total_steps=96",
    "checkpoint.every=32",
    "metric.log_every=24",
    "buffer.memmap=True",
    "buffer.device=True",
]


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_train_checkpoint_resume_evaluate(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import evaluate, run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    overrides = [*RUN, f"log_root={tmp_path / 'logs'}"]
    first = run(overrides)
    # 48 iterations over 2 envs, 8 of them prefill, replay ratio 0.5: ~1 step each
    assert first.policy_steps == 96 and first.grad_steps >= 35 and first.test_reward == 0.0
    ckpts = CheckpointManager(Path(first.log_dir) / "checkpoints").list_checkpoints()
    assert [p.name for p in ckpts] == ["ckpt_32", "ckpt_64", "ckpt_96"]
    state = CheckpointManager.load(ckpts[-1])
    assert set(state["params"]) == set(state["opt_states"]) == {"world_model", "actor", "critic"}
    assert state["opt_states"]["world_model"]["count"] == state["cumulative_grad_steps"] == first.grad_steps
    assert "actor_type" not in state and "rb" in state

    resumed = run([*overrides, f"checkpoint.resume_from={ckpts[0]}"])
    assert resumed.policy_steps == 96 and resumed.grad_steps > 0
    mid = CheckpointManager.load(ckpts[0])
    state = CheckpointManager.load(resumed.checkpoint)
    assert state["opt_states"]["world_model"]["count"] == mid["cumulative_grad_steps"] + resumed.grad_steps

    result = evaluate([f"checkpoint_path={resumed.checkpoint}", "device=cpu", "env.capture_video=False"])
    assert result.reward == 0.0 and result.steps > 0


def test_entry_asks_for_cuda_by_default(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.cli import run

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        run([r for r in RUN if r != "device=cpu"] + [f"log_root={tmp_path}"])


# ---------------------------------------------------------------------------------------
# The config checks, against the JAX package's on the same composed configs
# ---------------------------------------------------------------------------------------

PIXEL_CASES = [
    (["exp=dreamer_v2_dummy", "env.screen_size=96"], True),
    (["exp=dreamer_v2_dummy", "env.frame_stack=2"], True),
    (["exp=dreamer_v1_dummy", "env.screen_size=32"], True),
    (["exp=p2e_dv1_dummy", "env.frame_stack=3"], True),
    (["exp=p2e_dv2_dummy", "env.screen_size=128"], True),
    (["exp=dreamer_v2_dummy", "env.screen_size=64"], False),
    (["exp=dreamer_v1_dummy", "env.screen_size=64", "env.frame_stack=1"], False),
    # no pixel keys: any geometry
    (["exp=dreamer_v2_dummy", "algo.cnn_keys.encoder=[]", "env.screen_size=96"], False),
    (["exp=p2e_dv2_dummy", "algo.cnn_keys.encoder=[]", "env.screen_size=32", "env.frame_stack=4"], False),
    # DreamerV3 is not pinned
    (["exp=dreamer_v3_dummy", "env.screen_size=96"], False),
]
PREFILL_CASES = [
    (["exp=p2e_dv2_dummy", "algo.name=p2e_dv2_finetuning", "algo.learning_starts=4"], True),
    (["exp=p2e_dv2_dummy", "algo.name=p2e_dv2_finetuning", "algo.learning_starts=4", "buffer.load_from_exploration=True"], False),
    (["exp=p2e_dv1_dummy", "algo.name=p2e_dv1_finetuning", "algo.learning_starts=4", "buffer.load_from_exploration=True"], False),
]


def check_both(overrides):
    """Each package's ``check_configs`` on its own composition of ``overrides``: the
    exception each raises, or None."""
    import sheeprl_tpu.algos  # noqa: F401  (the reference's registry)
    import sheeprl_tpu_torch.algos  # noqa: F401
    from sheeprl_tpu.cli import check_configs as jax_check
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.cli import check_configs
    from sheeprl_tpu_torch.config.core import compose

    out = []
    for check, cfg in ((jax_check, jax_compose(overrides=overrides)), (check_configs, compose(overrides=[*overrides, "device=cpu"]))):
        try:
            check(cfg)
            out.append(None)
        except ValueError as exc:
            out.append(exc)
    return out


@pytest.mark.parametrize("overrides,refused", PIXEL_CASES + PREFILL_CASES)
def test_config_checks_match_the_reference(overrides, refused):
    jax_exc, port_exc = check_both(overrides)
    assert (jax_exc is not None) == (port_exc is not None) == refused, (jax_exc, port_exc)
    if refused:
        assert str(port_exc) == str(jax_exc) or "learning_starts" in str(port_exc)
