"""The port's headline-row bench (``sheeprl_tpu_torch/benchmarks/train_bench.py``) on the
CPU at a tiny size: every row it prints in turns, and its refusal to time a card it does
not have. Its rates are host numbers here and stand for no device."""

import json

import pytest
import torch

from sheeprl_tpu_torch.benchmarks import train_bench

TINY_WIDTHS = [
    "algo.dense_units=16",
    "algo.mlp_layers=1",
    "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.world_model.recurrent_model.recurrent_state_size=32",
    "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4",
    "algo.world_model.reward_model.bins=15",
    "algo.critic.bins=15",
    "algo.horizon=3",
]


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads: the tiny agent gains nothing from more, and the suite's
    other workers share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


def test_train_bench_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_bench.main(["--rows", "train"])


def test_train_only_rows_in_turns_on_the_cpu(capsys):
    train_bench.main([
        "--device", "cpu", "--rows", "train", "--mode", "turns", "--size", "XS", "--batch", "2", "--seq", "8",
        "--warmup", "1", "--steps", "2", "--train-overrides", *TINY_WIDTHS,
    ])
    rows = _lines(capsys)
    assert [r.get("mode") for r in rows[:-1]] == ["graph", "eager", "eager", "graph"] and rows[-1] == {"device": "cpu"}
    for r in rows[:-1]:
        assert r["bench"] == "train_only" and (r["batch"], r["seq"], r["steps"]) == (2, 8, 2) and r["grad_steps_per_sec"] > 0


def test_e2e_rows_on_the_cpu(capsys):
    """Device and host replay each run the train entry to its end with the same
    gradient steps (the replay ratio sets them), and log the loop's rates."""
    for replay in ("device", "host"):
        train_bench.main([
            "--device", "cpu", "--rows", "e2e", "--replay", replay, "--e2e-steps", "48", "--e2e-overrides",
            "algo=dreamer_v3_XS", *TINY_WIDTHS, "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=8",
            "env.num_envs=2", "algo.learning_starts=16", "algo.replay_ratio=0.25", "buffer.size=1024", "metric.log_every=8",
        ])
    rows = [r for r in _lines(capsys) if r.get("bench") == "e2e"]
    assert [r["replay"] for r in rows] == ["device", "host"]
    assert len({r["grad_steps"] for r in rows}) == 1 and rows[0]["grad_steps"] > 0
    for r in rows:
        assert r["e2e_policy_steps_per_sec"] > 0 and r["e2e_sps_train"] > 0 and r["e2e_sps_env_interaction"] > 0
