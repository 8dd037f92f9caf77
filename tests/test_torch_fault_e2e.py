"""The PyTorch port's training fault tolerance end to end on the CPU, in process, at tiny
sizes: the chaos kill (SIGTERM to this process at a loop boundary) with and without
``fault.autoresume``.

* Without autoresume: the run ends at the boundary with a checkpoint and the
  ``PREEMPTED`` marker, and the train entry exits 75. A job's handlers are the job's
  only: the process's own (the reference's in this test process) are put back after it.
* The Anakin PPO and SAC runs, killed and autoresumed, end with a final checkpoint equal
  bit for bit to an uninterrupted run's: their carry holds the generators.
* An Anakin PPO resume from a corrupted newest checkpoint falls back to the one before.
* DreamerV3: the final counters, the optimizer's count, the checkpoint names of each
  ``version_*``, the marker and the logged ``Fault/*`` values equal the reference loop's
  schedule (``chip_smoke.fault_schedule``, which the card's drills hold their runs to). Its values are not bit-identical to
  an uninterrupted run's: the host loops' player and trainer generators are not in the
  checkpoint, in the reference either.
* ``exp=ppo`` killed at the same step in both packages: the same checkpoint names per
  ``version_*``, the same marker fields and the same ``Fault/*`` names and values in the
  logged metrics (the one JAX run of this file).

Every run that sends itself a signal runs on the main thread (``on_main_thread``)."""

from pathlib import Path

import pytest
import torch

from chip_smoke import fault_schedule
from tests.torch_fault_common import Recorder, clean_fault_state, on_main_thread  # noqa: F401  (an autouse fixture)

ANAKIN = {
    "ppo_anakin": ["exp=ppo_anakin", "algo.rollout_steps=8", "env.num_envs=4", "algo.per_rank_batch_size=8", "algo.update_epochs=1",
                   "algo.total_steps=64", "algo.dense_units=8", "algo.encoder.mlp_features_dim=8"],
    "sac_anakin": ["exp=sac_anakin", "env.num_envs=4", "algo.hidden_size=16", "algo.per_rank_batch_size=8", "algo.learning_starts=16",
                   "algo.total_steps=64", "algo.anakin_steps_per_dispatch=4", "buffer.size=256"],
}
COMMON = ["device=cpu", "mesh.precision=32-true", "checkpoint.every=16", "metric.log_every=16", "env.capture_video=False",
          "algo.run_test=False"]
DV3 = ["exp=dreamer_v3_dummy", "algo=dreamer_v3_XS", "env=discrete_dummy", "env.screen_size=64", "algo.dense_units=16", "algo.mlp_layers=2",
       "algo.world_model.encoder.cnn_channels_multiplier=4", "algo.world_model.recurrent_model.recurrent_state_size=32",
       "algo.world_model.transition_model.hidden_size=16", "algo.world_model.representation_model.hidden_size=16",
       "algo.world_model.stochastic_size=4", "algo.world_model.discrete_size=4", "algo.world_model.reward_model.bins=15",
       "algo.critic.bins=15", "device=cpu", "env.num_envs=2", "env.sync_env=True", "env.wrapper.n_steps=20", "algo.total_steps=96",
       "algo.learning_starts=16", "algo.replay_ratio=0.5", "checkpoint.every=32", "metric.log_every=16", "algo.run_test=False"]
PPO = ["exp=ppo_dummy", "algo.rollout_steps=8", "algo.per_rank_batch_size=8", "algo.update_epochs=2", "algo.dense_units=8",
       "algo.mlp_layers=1", "algo.total_steps=64", "env.num_envs=2", "env.sync_env=True", "env.capture_video=False", "checkpoint.every=16",
       "metric.log_every=16", "env.max_episode_steps=3", "algo.run_test=False"]
KILL = ["chaos.kill_at_step=32", "fault.autoresume=True"]


@pytest.fixture(autouse=True)
def few_threads(monkeypatch):
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    yield
    torch.set_num_threads(before)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def unequal(a, b):
    """The leaves of two checkpoint states that differ (by path), or a key mismatch."""
    la, lb = dict(leaves(a)), dict(leaves(b))
    if sorted(la) != sorted(lb):
        return ["<keys>"]
    return [k for k in la if not (torch.equal(la[k], lb[k]) if isinstance(la[k], torch.Tensor) else la[k] == lb[k])]


def ckpt_names(root: Path):
    """The checkpoint names under a run tree, as ``version_N/ckpt_S``, in order."""
    return sorted((f"{p.parent.parent.name}/{p.name}" for p in root.rglob("checkpoints/ckpt_*")),
                  key=lambda s: (int(s.split("/")[0][8:]), int(s.split("_")[-1])))


def markers(root: Path):
    """Each ``PREEMPTED`` marker under a run tree, its resume checkpoint relative to the
    run dir and without its time."""
    from sheeprl_tpu_torch.fault.preemption import read_marker

    out = {}
    for path in sorted(root.rglob("PREEMPTED")):
        m = read_marker(path.parent)
        run_dir = path.parent.parent
        out[path.parent.name] = {"step": m["step"], "signal": m["signal"],
                                 "resume_from": str(Path(m["resume_from"]).relative_to(run_dir)) if m["resume_from"] else None}
    return out


def test_sigterm_without_autoresume_leaves_a_checkpoint_and_the_marker_and_exits_75(tmp_path):
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.fault.counters import fault_metrics

    on_main_thread()
    with pytest.raises(SystemExit) as info:
        run([*PPO, "device=cpu", "metric.log_level=0", "chaos.kill_at_step=24", f"log_root={tmp_path}"])
    assert info.value.code == 75
    assert ckpt_names(tmp_path) == ["version_0/ckpt_16", "version_0/ckpt_32"]
    assert markers(tmp_path) == {"version_0": {"step": 32, "signal": "SIGTERM", "resume_from": "version_0/checkpoints/ckpt_32"}}
    assert fault_metrics() == {"Fault/chaos_injected": 1, "Fault/preemption_signals": 1, "Fault/preemptions": 1}


def test_a_job_puts_the_process_handlers_back(tmp_path):
    """The train entry installs its handlers for a job only: a reference run's handler
    (installed for good, behind its ``_installed`` flag) is in place again after a port
    job, and a SIGTERM then reaches the reference's flag, not the port's."""
    import os
    import signal
    import time

    from sheeprl_tpu.fault import preemption as ref_preemption
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.fault import preemption

    on_main_thread()
    ref_preemption._installed = False
    assert ref_preemption.install_signal_handlers()
    run([*PPO, "device=cpu", "metric.log_level=0", "algo.total_steps=16", f"log_root={tmp_path}"])
    assert signal.getsignal(signal.SIGTERM) is ref_preemption._handler and signal.getsignal(signal.SIGINT) is ref_preemption._handler
    os.kill(os.getpid(), signal.SIGTERM)
    deadline = time.monotonic() + 5.0
    while not ref_preemption.preemption_requested() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ref_preemption.preemption_requested() and not preemption.preemption_requested()


@pytest.mark.parametrize("exp", list(ANAKIN))
def test_anakin_kill_and_autoresume_equals_the_uninterrupted_run(tmp_path, exp):
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.fault.counters import fault_metrics

    on_main_thread()
    killed = run([*ANAKIN[exp], *COMMON, "metric.log_level=0", *KILL, f"log_root={tmp_path / 'killed'}"])
    assert fault_metrics() == {"Fault/chaos_injected": 1, "Fault/preemption_signals": 1, "Fault/preemptions": 1, "Fault/restarts": 1}
    clean = run([*ANAKIN[exp], *COMMON, "metric.log_level=0", f"log_root={tmp_path / 'clean'}"])
    assert Path(killed.checkpoint).name == Path(clean.checkpoint).name == "ckpt_64"
    assert Path(killed.log_dir).name == "version_1" and killed.grad_steps < clean.grad_steps
    assert unequal(CheckpointManager.load(killed.checkpoint), CheckpointManager.load(clean.checkpoint)) == []
    assert markers(tmp_path / "killed") == {"version_0": {"step": 32, "signal": "SIGTERM", "resume_from": "version_0/checkpoints/ckpt_32"}}


def test_anakin_resume_falls_back_past_a_corrupted_newest_checkpoint(tmp_path):
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.fault.chaos import corrupt_file

    first = run([*ANAKIN["ppo_anakin"], *COMMON, "metric.log_level=0", f"log_root={tmp_path}"])
    latest = Path(first.checkpoint)
    assert latest.name == "ckpt_64"
    final = CheckpointManager.load(latest)
    corrupt_file(latest / "carry.pt", mode="bitflip", seed=0)
    assert not CheckpointManager.verify(latest)
    with pytest.warns(UserWarning, match="fell back to .*ckpt_32"):
        resumed = run([*ANAKIN["ppo_anakin"], *COMMON, "metric.log_level=0", f"log_root={tmp_path}", f"checkpoint.resume_from={latest}"])
    # the run went on from ckpt_32 (one more update) and reached the first run's end bit for bit
    assert resumed.policy_steps == 64 and resumed.grad_steps == 4 and Path(resumed.checkpoint).name == "ckpt_64"
    assert unequal(CheckpointManager.load(resumed.checkpoint), final) == []


def test_dreamer_v3_kill_and_autoresume_keeps_the_schedule(tmp_path, monkeypatch):
    import sheeprl_tpu_torch.algos.dreamer_loop as loop
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.config.core import compose

    on_main_thread()
    logs = []
    monkeypatch.setattr(loop, "get_logger", lambda cfg, log_dir: logs.append(Recorder()) or logs[-1])
    result = run([*DV3, "chaos.kill_at_step=40", "fault.autoresume=True", f"log_root={tmp_path}"])
    want = fault_schedule(compose(overrides=DV3), 40)
    state = CheckpointManager.load(result.checkpoint)
    got = {k: int(state[k]) for k in ("iter_num", "policy_step", "cumulative_grad_steps")}
    assert got == {k: want[k] for k in got} == {"iter_num": 48, "policy_step": 96, "cumulative_grad_steps": 32}
    assert int(state["opt_states"]["world_model"]["count"]) == want["cumulative_grad_steps"]
    assert ckpt_names(tmp_path) == [f"version_{v}/ckpt_{s}" for v, steps in enumerate(want["ckpts"]) for s in steps]
    assert markers(tmp_path) == {"version_0": {"step": 40, "signal": "SIGTERM", "resume_from": "version_0/checkpoints/ckpt_40"}}
    faults = {"Fault/chaos_injected": 1, "Fault/preemption_signals": 1, "Fault/preemptions": 1, "Fault/restarts": 1}
    assert [f for _, f in logs[0].fault()] == [{}, {}] and [f for _, f in logs[1].fault()] == [faults] * 4


def test_ppo_kill_matches_the_reference(tmp_path, monkeypatch):
    """The same kill in both packages' ``exp=ppo``: checkpoint names per version, the
    marker, the logged ``Fault/*``."""
    import sheeprl_tpu.algos.ppo.ppo as jax_ppo
    import sheeprl_tpu_torch.algos.ppo.ppo as ppo
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu_torch.cli import run

    on_main_thread()
    logs = {"jax": [], "port": []}
    monkeypatch.setattr(jax_ppo, "get_logger", lambda cfg, log_dir: logs["jax"].append(Recorder()) or logs["jax"][-1])
    monkeypatch.setattr(ppo, "get_logger", lambda cfg, log_dir: logs["port"].append(Recorder()) or logs["port"][-1])
    jax_run([*PPO, *KILL, f"log_root={tmp_path / 'jax'}"])
    result = run([*PPO, *KILL, "device=cpu", f"log_root={tmp_path / 'port'}"])
    assert result.policy_steps == 64 and Path(result.log_dir).name == "version_1"
    assert ckpt_names(tmp_path / "port") == ckpt_names(tmp_path / "jax") == [
        "version_0/ckpt_16", "version_0/ckpt_32", "version_1/ckpt_48", "version_1/ckpt_64"]
    assert markers(tmp_path / "port") == markers(tmp_path / "jax") == {
        "version_0": {"step": 32, "signal": "SIGTERM", "resume_from": "version_0/checkpoints/ckpt_32"}}
    fault = {name: [r.fault() for r in recs] for name, recs in logs.items()}
    assert fault["port"] == fault["jax"]
    assert fault["port"][1][-1][1] == {"Fault/chaos_injected": 1, "Fault/preemption_signals": 1, "Fault/preemptions": 1, "Fault/restarts": 1}
