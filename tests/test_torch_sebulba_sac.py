"""``python -m sheeprl_tpu_torch.sebulba exp=sac_decoupled`` on the CPU: the port's
launcher places a learner process and one actor process on the reference smoke's tiny
overrides (``tests/test_distributed/test_sebulba_smoke.py``), beside one run of the JAX
package's Sebulba on the same overrides. The summaries' ``blocks``, ``env_steps_total``,
``cumulative_grad_steps`` and ``publishes`` do not depend on draws, and are equal. The
learner's checkpoint resumes (a second placement loads its parameters and optimizer
state) and evaluates through ``python -m sheeprl_tpu_torch.eval``'s entry. At
``exp=sac_decoupled``'s widths (a 296 KB publication, 172 KB blocks) two actors finish
with every socket's buffers cut to 16 KB: an actor that read its channel only between
its sends hung with the learner there."""

from pathlib import Path

import pytest
import torch

from tests.torch_sebulba_common import (
    PORT_CPU,
    QUIET_LOG,
    SAC_OVERRIDES,
    SMALL_SOCKET_BUFFERS,
    Run,
    child_env,
    jax_env,
    run_ok,
    summary,
)

COUNTS = ("blocks", "env_steps_total", "cumulative_grad_steps", "publishes")
PLACEMENT = ["distributed.num_actors=1", "distributed.connect_timeout_s=30"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's placement and the JAX package's, side by side."""
    tmp = tmp_path_factory.mktemp("sebulba_sac")
    port = Run("sheeprl_tpu_torch.sebulba", [*SAC_OVERRIDES, *PORT_CPU, *PLACEMENT, f"log_root={tmp}/port"],
               child_env(SHEEPRL_TPU_SEBULBA_SUMMARY=tmp / "port.json"))
    ref = Run("sheeprl_tpu.sebulba", [*SAC_OVERRIDES, *PLACEMENT, f"log_root={tmp}/jax"],
              jax_env(SHEEPRL_TPU_SEBULBA_SUMMARY=tmp / "jax.json"))
    outs = run_ok([port, ref], timeout=240)
    return {"tmp": tmp, "port": summary(tmp / "port.json"), "jax": summary(tmp / "jax.json"), "out": outs[0]}


def test_summary_counts_equal_the_jax_packages(runs):
    port, ref = runs["port"], runs["jax"]
    assert {k: port[k] for k in COUNTS} == {k: ref[k] for k in COUNTS}
    # 16 total steps / 2 envs: 8 actor iterations, each shipped as a block
    assert port["blocks"] == 8 and port["env_steps_total"] == 16 and port["cumulative_grad_steps"] > 0
    assert port["error"] is None and port["policy_step"] == ref["policy_step"]


def test_param_staleness_as_the_jax_packages(runs):
    """The actors' lead over the learner, the port's against the reference's on the same
    placement: at these shapes each actor ships its 8 blocks before it adopts any
    publication in both packages (the learner starts its first update after the actors
    are done), so neither measures a staleness: the port's summary counts none, and the
    reference's fleet timeline holds no ``Sebulba/param_staleness_steps`` gauge."""
    timelines = list((runs["tmp"] / "jax").rglob("fleet/timeline.jsonl"))
    assert timelines
    ref_gauges = sum(line.count("Sebulba/param_staleness_steps") for t in timelines for line in t.read_text().splitlines())
    assert runs["port"]["staleness_steps"]["n"] == ref_gauges == 0


def test_summary_accounts_for_the_channel_and_the_processes(runs):
    port = runs["port"]
    assert port["bytes_received"] > 0 and port["bytes_published"] > 0
    events = [tuple(e[1:]) for e in port["events"]]
    assert events == [(0, 0, "connected"), (0, 0, "done")]
    trace = [g for _, g in port["grad_step_trace"]]
    assert len(trace) == port["blocks"] and trace == sorted(trace) and trace[-1] == port["cumulative_grad_steps"]
    # the learner and the actor report their launch counts (no kernel on a SAC path) and
    # their peak device memory (none on the CPU)
    assert set(port["actors"]) == {"0_g0"} and port["actors"]["0_g0"]["env_steps"] == 16
    for stats in (port["learner"], port["actors"]["0_g0"]):
        assert not any(stats["launches"].values()) and stats["peak_bytes"] is None
    assert port["publish_ms"]["host"] >= 0 and port["publish_ms"]["send"] >= 0
    assert "[sebulba] learner exited rc=0" in runs["out"]


def test_learner_checkpoints_resume_and_evaluate(runs, monkeypatch):
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import evaluate

    tmp = runs["tmp"]
    ckpts = sorted((tmp / "port").rglob("ckpt_*"), key=lambda p: int(p.name.split("_")[1]))
    # the learner's checkpoints (checkpoint.every=8 and the last); actors write none
    assert [p.name for p in ckpts] == ["ckpt_8", "ckpt_16"] and all("_actor" not in str(p) for p in ckpts)
    assert runs["port"]["checkpoint"] == str(ckpts[-1])
    state = CheckpointManager.load(ckpts[-1])
    assert {"params", "opt_state", "iter_num", "policy_step", "cumulative_grad_steps"} <= set(state)

    resumed = Run("sheeprl_tpu_torch.sebulba", [*SAC_OVERRIDES, *PORT_CPU, *QUIET_LOG, *PLACEMENT, f"log_root={tmp}/resumed",
                                                f"checkpoint.resume_from={ckpts[0]}", "checkpoint.every=0"],
                  child_env(SHEEPRL_TPU_SEBULBA_SUMMARY=tmp / "resumed.json"))
    run_ok([resumed], timeout=120)
    again = summary(tmp / "resumed.json")
    # as the reference's learner: the parameters and optimizer state resume, the actors refill their shards
    assert again["error"] is None and again["blocks"] == 8 and again["cumulative_grad_steps"] == runs["port"]["cumulative_grad_steps"]
    last = CheckpointManager.load(again["checkpoint"])
    first = CheckpointManager.load(ckpts[0])
    assert int(last["opt_state"]["critic"]["count"]) == int(first["opt_state"]["critic"]["count"]) + again["cumulative_grad_steps"]

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    torch.set_num_threads(2)
    result = evaluate([f"checkpoint_path={again['checkpoint']}", "device=cpu", "env.capture_video=False", f"log_root={tmp}/eval"])
    assert result.steps > 0 and result.reward == result.reward
    assert Path(again["checkpoint"]).parent.parent.joinpath("config.yaml").is_file()


def test_published_widths_finish_with_small_socket_buffers(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(SMALL_SOCKET_BUFFERS)
    run = Run("sheeprl_tpu_torch.sebulba", ["exp=sac_decoupled", "env.sync_env=True", "algo.total_steps=256", "algo.learning_starts=64",
                                            "distributed.num_actors=2", "algo.run_test=False", "checkpoint.every=0", *PORT_CPU,
                                            *QUIET_LOG, f"log_root={tmp_path}/logs"],
              child_env(SHEEPRL_TPU_SEBULBA_SUMMARY=tmp_path / "summary.json", PYTHONPATH=tmp_path))
    run_ok([run], timeout=120)
    s = summary(tmp_path / "summary.json")
    # 2 actors x 32 iterations, learning from the 8th: 4 gradient steps (256 rows each) a block
    assert s["error"] is None and s["blocks"] == 64 and s["cumulative_grad_steps"] == 2 * 25 * 4 and s["publishes"] == 50
