"""DreamerV2 through the PyTorch port's train and eval entries on the CPU, at the
``dreamer_v2_dummy`` exp's tiny size: it trains, checkpoints, resumes from a checkpoint
and evaluates the last one, with the sequential buffer (its rows mirrored in the device
ring, ``buffer.device=True``) and with the episode buffer (which samples on the host
even so);
and a config key that asks for a loop feature the port lacks raises, naming the key."""

from pathlib import Path

import pytest
import torch

RUN = [
    "exp=dreamer_v2_dummy",
    "device=cpu",
    "env.sync_env=True",
    "env.wrapper.n_steps=10",  # 12 stored rows per episode, at least a sequence (8)
    "algo.total_steps=96",
    "algo.learning_starts=32",  # a whole episode per env before the first step
    "checkpoint.every=32",
    "metric.log_every=24",
    "buffer.memmap=True",
]
BUFFERS = {
    "sequential": ["buffer.type=sequential", "buffer.device=True"],
    # buffer.device=True too: the ring mirrors the sequential buffer only, so the loop
    # logs it and samples the episodes on the host
    "episode": ["buffer.type=episode", "buffer.prioritize_ends=True", "buffer.device=True"],
}


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("buffer", sorted(BUFFERS))
def test_train_checkpoint_resume_evaluate(tmp_path, monkeypatch, caplog, buffer):
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import evaluate, run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    overrides = [*RUN, *BUFFERS[buffer], f"log_root={tmp_path / 'logs'}"]
    first = run(overrides)
    assert ("episode buffer stays on the host" in caplog.text) == (buffer == "episode")
    # 48 iterations over 2 envs, 16 of them prefill, replay ratio 0.5: ~1 step each
    assert first.policy_steps == 96 and first.grad_steps >= 30 and first.test_reward == 0.0
    ckpts = CheckpointManager(Path(first.log_dir) / "checkpoints").list_checkpoints()
    assert [p.name for p in ckpts] == ["ckpt_32", "ckpt_64", "ckpt_96"]
    state = CheckpointManager.load(ckpts[-1])
    assert set(state) >= {"params", "opt_states", "ratio", "rb", "cumulative_grad_steps"} and "moments" not in state
    assert state["opt_states"]["world_model"]["count"] == state["cumulative_grad_steps"] == first.grad_steps
    if buffer == "episode":
        lengths = [int(ep["terminated"].shape[0]) for ep in state["rb"]["episodes"]]
        assert len(lengths) >= 4 and set(lengths) == {12}
    # the hard copy: the target critic equals the critic as it stood at the last copy
    # (every 100 gradient steps from the first), not the trained critic
    assert not all(torch.equal(state["params"]["critic"][k], v) for k, v in state["params"]["target_critic"].items())

    # a resumed run prefills learning_starts again before it trains, as the reference
    resumed = run([*overrides, f"checkpoint.resume_from={ckpts[0]}"])
    assert resumed.policy_steps == 96 and resumed.grad_steps > 0
    mid = CheckpointManager.load(ckpts[0])
    state = CheckpointManager.load(resumed.checkpoint)
    assert state["opt_states"]["world_model"]["count"] == mid["cumulative_grad_steps"] + resumed.grad_steps

    result = evaluate([f"checkpoint_path={resumed.checkpoint}", "device=cpu", "env.capture_video=False"])
    assert result.steps == 11 and result.reward == 0.0


@pytest.mark.parametrize(
    "override,word",
    [
        ("+fault.autoresume=True", "fault.autoresume"),
        ("+rollout.pipeline_depth=2", "rollout.pipeline_depth"),
        ("obs.fleet.dir=fleet", "obs.fleet.dir"),
        ("+mesh.data=2", "mesh.data"),
        ("mesh.precision=fp16", "fp16"),
    ],
)
def test_unported_keys_raise(tmp_path, monkeypatch, override, word):
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    with pytest.raises(NotImplementedError, match=word):
        run([*RUN, f"log_root={tmp_path}", override])


def test_entries_ask_for_cuda_by_default(tmp_path, monkeypatch):
    """Without ``device=cpu`` the train entry asks for CUDA, which this host lacks."""
    from sheeprl_tpu_torch.cli import run

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        run([r for r in RUN if r != "device=cpu"] + [f"log_root={tmp_path}"])


def test_minedojo_actor_is_refused():
    """On a MineDojo wrapper the build's actor is ``MinedojoActorV2`` (ported since PR 9,
    held against the reference in ``test_torch_minedojo_actor.py``), which refuses a
    continuous action space, as the reference's does."""
    import numpy as np

    from sheeprl_tpu_torch.algos.dreamer_v2.agent import MinedojoActorV2, build_agent
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.parallel.context import RunContext

    cfg = compose(overrides=[*RUN, "env.wrapper._target_=sheeprl_tpu.envs.minedojo.MineDojoWrapper"])
    obs_space = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 64, 64), np.uint8), "state": spaces.Box(-20, 20, (10,), np.float32)})
    assert isinstance(build_agent(RunContext(torch.device("cpu"), 0), (19, 4, 6), False, cfg, obs_space)[1], MinedojoActorV2)
    with pytest.raises(ValueError, match="MinedojoActorV2 only supports the functional MultiDiscrete"):
        build_agent(RunContext(torch.device("cpu"), 0), (3,), True, cfg, obs_space)
