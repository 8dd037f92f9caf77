"""The PyTorch port's evaluation entry end to end on the CPU, and its checkpoints.

* ``sheeprl_tpu_torch.cli.evaluate([... "device=cpu"])`` runs a DreamerV3 episode from a
  checkpoint written by the port's ``CheckpointManager`` and prints
  ``Test/cumulative_reward``.
* A checkpoint round-trips bit for bit, and a damaged one falls back to the newest
  earlier checkpoint that verifies.
* Without ``device=cpu`` the entry asks for CUDA, and raises where there is none.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_dv3_agent import TINY


def _write_run(tmp_path, seed=5):
    """A run dir as training leaves it: config.yaml + checkpoints/ckpt_1."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent, parse_actions_dim
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.config.core import compose, save_config
    from sheeprl_tpu_torch.parallel.context import RunContext
    from sheeprl_tpu_torch.utils.env import make_env

    cfg = compose(overrides=[*TINY, f"seed={seed}"])
    env = make_env(cfg, cfg.seed, 0, None)()
    is_continuous, actions_dim = parse_actions_dim(env.action_space)
    modules = build_agent(RunContext(torch.device("cpu"), seed), actions_dim, is_continuous, cfg, env.observation_space)[:4]
    names = ("world_model", "actor", "critic", "target_critic")
    params = {n: m.state_dict() for n, m in zip(names, modules)}
    save_config(cfg, tmp_path / "run" / "config.yaml")
    ckpt = CheckpointManager(tmp_path / "run" / "checkpoints").save(1, {"params": params})
    return ckpt, params


def test_evaluate_runs_end_to_end_on_cpu(tmp_path, monkeypatch, capsys):
    from sheeprl_tpu_torch.cli import evaluate
    from sheeprl_tpu_torch.ops.gru import layernorm_gru

    monkeypatch.chdir(tmp_path)
    ckpt, _ = _write_run(tmp_path)
    before = layernorm_gru.launches
    result = evaluate([f"checkpoint_path={ckpt}", "device=cpu", "env.capture_video=False", "env.wrapper.n_steps=10"])
    out = capsys.readouterr().out
    assert "Test/cumulative_reward: 0.0" in out
    # DiscreteDummyEnv ends the episode on the step after its n_steps-th
    assert result.steps == 11 and result.reward == 0.0
    assert layernorm_gru.launches == before, "the CPU path launches no kernel"
    assert (tmp_path / "logs" / "runs").is_dir()


def test_evaluate_without_device_asks_for_cuda(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.cli import evaluate

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt, _ = _write_run(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate([f"checkpoint_path={ckpt}", "env.capture_video=False"])


def test_checkpoint_round_trips_bit_exactly(tmp_path):
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager

    ckpt, params = _write_run(tmp_path)
    state = CheckpointManager.load(ckpt)
    assert state["_step"] == 1
    assert set(state["params"]) == set(params)
    for name, sd in params.items():
        assert list(state["params"][name]) == list(sd)
        for k, v in sd.items():
            got = state["params"][name][k]
            assert got.dtype == v.dtype and np.array_equal(got.numpy().view(np.uint8), v.numpy().view(np.uint8)), f"{name}.{k}"


def test_damaged_checkpoint_falls_back_to_an_earlier_one(tmp_path):
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointCorruptError, CheckpointManager

    manager = CheckpointManager(tmp_path / "ckpts", keep_last=2)
    for step in (1, 2, 3):
        manager.save(step, {"x": torch.full((4,), float(step)), "meta": {"step": step}})
    assert [p.name for p in manager.list_checkpoints()] == ["ckpt_2", "ckpt_3"]
    newest = tmp_path / "ckpts" / "ckpt_3"
    blob = bytearray((newest / "x.pt").read_bytes())
    blob[-1] ^= 0xFF
    (newest / "x.pt").write_bytes(bytes(blob))
    assert not CheckpointManager.verify(newest)
    with pytest.warns(UserWarning, match="fell back"):
        state = CheckpointManager.load(newest)
    assert state["_step"] == 2 and torch.equal(state["x"], torch.full((4,), 2.0))
    assert CheckpointManager.latest_valid(tmp_path / "ckpts").name == "ckpt_2"
    with pytest.raises(CheckpointCorruptError):
        CheckpointManager.load(newest, fallback=False)
    # a writer killed mid-save leaves a tmp dir, which the next manager sweeps
    (tmp_path / "ckpts" / ".tmp_ckpt_4").mkdir()
    with pytest.warns(UserWarning, match="orphaned"):
        CheckpointManager(tmp_path / "ckpts")
    assert not (tmp_path / "ckpts" / ".tmp_ckpt_4").exists()
