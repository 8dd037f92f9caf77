"""``python -m sheeprl_tpu_torch.supervise`` on the CPU.

* A SIGKILL drill as a subprocess in a session of its own: the first attempt corrupts
  its newest checkpoint (``chaos.corrupt_ckpt_at_step``) and is SIGKILLed at a later
  boundary; the supervisor classifies the death RETRY, skips the corrupted checkpoint,
  resumes from the one before it and exits 0, its summary accounting for both attempts.
* A child whose blackbox names ``NonFiniteError`` is not retried, one whose blackbox
  names another exception is, within ``fault.max_retries``, each held against the
  reference's supervisor on the same scripted deaths (``subprocess.run`` stubbed).
* ``--serve``: the respawn on rc 75 and the crash budget against the reference's
  ``supervise_serve`` on the same scripted exit codes; the fleet keys refused by name."""

import json
import subprocess
import time
from types import SimpleNamespace

import pytest

from tests.torch_fault_common import clean_fault_state  # noqa: F401  (an autouse fixture)
from tests.torch_sebulba_common import Run, child_env

RUN = ["exp=ppo_dummy", "device=cpu", "algo.rollout_steps=8", "algo.per_rank_batch_size=8", "algo.update_epochs=2", "algo.dense_units=8",
       "algo.mlp_layers=1", "algo.total_steps=96", "env.num_envs=2", "env.sync_env=True", "env.capture_video=False",
       "checkpoint.every=32", "metric.log_level=0", "env.max_episode_steps=3", "algo.run_test=False"]


def test_a_sigkilled_run_resumes_past_its_corrupted_newest_checkpoint(tmp_path):
    """16 policy steps an update, a checkpoint every 32: ckpt_64 is corrupted at its own
    boundary, the SIGKILL comes at 80, and the relaunch resumes from ckpt_32."""
    summary_path = tmp_path / "summary.json"
    run = Run("sheeprl_tpu_torch.supervise", [*RUN, f"log_root={tmp_path}", "run_name=drill", "chaos.corrupt_ckpt_at_step=64",
                                              "chaos.kill_at_step=80", "chaos.kill_signal=SIGKILL", "fault.backoff_s=0",
                                              f"fault.summary_path={summary_path}"], child_env())
    rc, out = run.wait(timeout=240)
    assert rc == 0, out[-4000:]
    s = json.loads(summary_path.read_text())
    run_dir = tmp_path / "runs" / "ppo" / "discrete_dummy" / "drill"
    assert s["outcome"] == "done" and s["rc"] == 0 and s["retries"] == 1 and s["preemptions"] == 0
    assert [(a["rc"], a["verdict"]) for a in s["attempts"]] == [(-9, "retry"), (0, "done")]
    assert s["attempts"][0]["resume_from"] is None
    assert s["attempts"][1]["resume_from"] == str(run_dir / "version_0" / "checkpoints" / "ckpt_32")
    assert "transient failure (rc=-9); retry 1/3" in out and "resuming from" in out
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager

    assert not CheckpointManager.verify(run_dir / "version_0" / "checkpoints" / "ckpt_64")
    final = CheckpointManager.load(run_dir / "version_1" / "checkpoints" / "ckpt_96")
    assert final["policy_step"] == 96 and final["update"] == 6 and int(final["opt_state"]["count"]) == 6 * 4
    # the relaunch ran without the first attempt's chaos schedule and wrote no marker
    assert not list(run_dir.rglob("PREEMPTED"))


@pytest.fixture
def scripted(tmp_path, monkeypatch):
    """Run a supervisor of either package against scripted deaths: each attempt's exit
    code, and the exception type its blackbox names (or None); the backoff's sleeps are
    recorded. Returns ``(rc, summary or None, sleeps, attempts' argv)``."""
    from sheeprl_tpu.fault.supervisor import SUPERVISE_SUMMARY_ENV_VAR

    monkeypatch.delenv(SUPERVISE_SUMMARY_ENV_VAR, raising=False)

    def go(supervise, overrides, deaths, run_dir=None):
        deaths, sleeps, argvs = iter(deaths), [], []

        def fake_run(argv, env=None, **kwargs):
            argvs.append(argv)
            rc, exc_type = next(deaths)
            if exc_type is not None:
                meta = run_dir / f"version_{len(argvs) - 1}" / "blackbox" / "meta.json"
                meta.parent.mkdir(parents=True)
                meta.write_text(json.dumps({"time": time.time(), "exception": {"type": exc_type}}))
            return SimpleNamespace(returncode=rc)

        monkeypatch.setattr(subprocess, "run", fake_run)
        monkeypatch.setattr(time, "sleep", lambda s: sleeps.append(s))
        summary_path = tmp_path / "summary.json"
        summary_path.unlink(missing_ok=True)
        rc = supervise([*overrides, f"fault.summary_path={summary_path}"])
        return rc, (json.loads(summary_path.read_text()) if summary_path.is_file() else None), sleeps, argvs

    return go


@pytest.mark.parametrize("deaths,want", [
    ([(1, "NonFiniteError")], (1, 1, [])),
    ([(1, "RuntimeError"), (-9, None), (0, None)], (0, 3, [0.5, 1.0])),
    ([(1, "RuntimeError")] * 3, (1, 3, [0.5, 1.0])),
], ids=["non-finite", "retried", "out-of-budget"])
def test_the_supervisor_retries_what_the_reference_retries(tmp_path, scripted, deaths, want):
    from sheeprl_tpu.fault.supervisor import supervise as jax_supervise
    from sheeprl_tpu_torch.fault.supervisor import supervise

    base = ["exp=ppo_dummy", "fault.max_retries=2", "fault.backoff_s=0.5", "run_name=drill"]
    got = {}
    for name, fn, root in (("jax", jax_supervise, tmp_path / "jax"), ("port", supervise, tmp_path / "port")):
        run_dir = root / "runs" / "ppo" / "discrete_dummy" / "drill"
        rc, summary, sleeps, argvs = scripted(fn, [*base, f"log_root={root}"], deaths, run_dir)
        got[name] = (rc, len(argvs), sleeps)
        assert all(a[1:3] == ["-m", "sheeprl_tpu" if name == "jax" else "sheeprl_tpu_torch"] for a in argvs)
        assert all("fault.autoresume=False" in a and "run_name=drill" in a for a in argvs)
    assert got["port"] == got["jax"] == want
    assert summary["attempts"][0]["exception"] == deaths[0][1]
    assert summary["outcome"] == {0: "done", 1: "fatal" if deaths[0][1] == "NonFiniteError" else "retry_budget"}[want[0]]


SERVE = ["fault.max_retries=3", "fault.backoff_s=2.0", "fault.backoff_max_s=60.0"]


@pytest.mark.parametrize("rcs,extra", [
    ([1, 75, 1, 1, 0], []),  # a drained preemption respawns at once and resets the backoff
    ([2, 2, 2, 2], []),  # the crash budget
    ([75, 75], ["fault.max_preemptions=1"]),
    ([75, 75, 75, 0], []),
], ids=["preemption", "crash-budget", "preemption-budget", "respawn"])
def test_serve_mode_matches_the_reference(scripted, rcs, extra):
    from sheeprl_tpu.fault.supervisor import supervise_serve as jax_serve
    from sheeprl_tpu_torch.fault.supervisor import supervise

    got = {}
    for name, fn in (("jax", jax_serve), ("port", lambda ovs: supervise(["--serve", *ovs]))):
        rc, summary, sleeps, argvs = scripted(fn, [*SERVE, *extra], [(rc, None) for rc in rcs])
        events = [e["kind"] for e in summary["events"]]
        got[name] = (rc, sleeps, len(argvs), {k: summary[k] for k in ("attempts", "retries", "preemptions", "outcome", "rc")}, events)
        assert all(a[1:3] == ["-m", "sheeprl_tpu.serve" if name == "jax" else "sheeprl_tpu_torch.serve"] for a in argvs)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("override,key", [("serve.fleet.enabled=True", r"serve\.fleet\.enabled"), ("+obs.fleet.dir=fleet", r"obs\.fleet\.dir")])
def test_serve_mode_refuses_the_fleet(override, key):
    from sheeprl_tpu_torch.fault.supervisor import supervise

    with pytest.raises(NotImplementedError, match=key):
        supervise(["--serve", override])
