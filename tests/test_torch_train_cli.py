"""DreamerV3 training through the PyTorch port's train entry on the CPU, at a tiny
size: it trains, checkpoints, resumes from a checkpoint and evaluates the last one; and
a config key that asks for a loop feature the port lacks raises, naming the key."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests.test_torch_dv3_agent import TINY

REPO = Path(__file__).resolve().parent.parent
RUN = [
    *TINY,
    "device=cpu",
    "env.num_envs=2",
    "env.sync_env=False",
    "env.wrapper.n_steps=20",
    "algo.total_steps=64",
    "algo.learning_starts=16",
    "algo.replay_ratio=0.5",
    "checkpoint.every=32",
    "metric.log_every=16",
    "buffer.memmap=True",
]


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads: the tiny agent gains nothing from more, and the suite's
    other workers share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_train_checkpoint_resume_evaluate(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import evaluate, run
    from sheeprl_tpu_torch.ops.gru import layernorm_gru, layernorm_gru_backward

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    overrides = [*RUN, f"log_root={tmp_path / 'logs'}"]
    launches = (layernorm_gru.launches, layernorm_gru_backward.launches)
    first = run(overrides)
    assert (layernorm_gru.launches, layernorm_gru_backward.launches) == launches, "the CPU path launches no kernel"
    # 32 iterations, 8 of them prefill, replay ratio 0.5 over 2 envs: ~1 step per iteration
    assert first.policy_steps == 64 and first.grad_steps >= 20 and first.test_reward == 0.0
    ckpts = CheckpointManager(Path(first.log_dir) / "checkpoints").list_checkpoints()
    assert [p.name for p in ckpts] == ["ckpt_32", "ckpt_64"]
    state = CheckpointManager.load(ckpts[-1])
    assert set(state) >= {"params", "opt_states", "moments", "ratio", "rb", "cumulative_grad_steps"}
    assert state["opt_states"]["world_model"]["count"] == state["cumulative_grad_steps"] == first.grad_steps
    assert list((Path(first.log_dir)).glob("events.out.tfevents.*")) or (Path(first.log_dir) / "metrics.jsonl").is_file()

    resumed = run([*overrides, f"checkpoint.resume_from={ckpts[0]}"])
    assert resumed.policy_steps == 64 and resumed.grad_steps > 0
    state = CheckpointManager.load(resumed.checkpoint)
    mid = CheckpointManager.load(ckpts[0])
    assert state["opt_states"]["world_model"]["count"] == mid["cumulative_grad_steps"] + resumed.grad_steps

    result = evaluate([f"checkpoint_path={resumed.checkpoint}", "device=cpu", "env.capture_video=False"])
    assert result.steps == 21 and result.reward == 0.0


@pytest.mark.parametrize(
    "override,word",
    [
        ("+fault.autoresume=True", "fault.autoresume"),
        ("+rollout.pipeline_depth=2", "rollout.pipeline_depth"),
        ("+env.pool.enabled=True", "env.pool.enabled"),
        ("+obs.enabled=True", "obs.enabled"),
        ("mesh.precision=fp16", "fp16"),
    ],
)
def test_unported_keys_raise(tmp_path, monkeypatch, override, word):
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    with pytest.raises(NotImplementedError, match=word):
        run([*RUN, "env.sync_env=True", f"log_root={tmp_path}", override])


def test_module_entry_runs_the_cli():
    """``python -m sheeprl_tpu_torch`` reaches the train entry (here: a key it refuses)."""
    proc = subprocess.run(
        [sys.executable, "-m", "sheeprl_tpu_torch", *RUN, "+fault.autoresume=True", "log_root=/nonexistent/never-written"],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=120,
        env={"PATH": "/usr/bin:/bin", "SHEEPRL_TPU_QUIET": "1", "HOME": str(REPO)},
    )
    assert proc.returncode != 0 and "fault.autoresume" in proc.stderr, proc.stderr[-2000:]
    assert torch.__version__  # the port's entry imports torch only
