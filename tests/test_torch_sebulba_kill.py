"""Faults of a Sebulba placement of the port on the CPU (counterpart of
``tests/test_distributed/test_actor_kill.py``, on its run):

* ``chaos.kill_actor_at_step`` SIGKILLs actor 0 mid-run (``KILL_SAC``); the launcher
  respawns it as generation 1, which reconnects and finishes; the learner's
  gradient-step count rises strictly inside the kill window (actor 1 kept feeding it)
  and the run exits 0;
* with ``distributed.max_actor_respawns=0`` the killed slot is abandoned: the launcher
  tells the learner, which ends cleanly on the other actor's blocks;
* a SIGTERM to the launcher reaches the learner, which ends at the training guard with a
  checkpoint, the ``PREEMPTED`` marker and exit 75, and the launcher exits with its code."""

import json
import os
import signal
import time
from pathlib import Path

import pytest

from tests.torch_sebulba_common import KILL_SAC, PORT_CPU, QUIET_LOG, Run, child_env, run_ok, summary


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sebulba_kill")
    base = [*KILL_SAC, *PORT_CPU, *QUIET_LOG]
    respawned = Run("sheeprl_tpu_torch.sebulba", [*base, f"log_root={tmp}/respawn"],
                    child_env(SHEEPRL_TPU_SEBULBA_SUMMARY=tmp / "respawn.json"))
    abandoned = Run("sheeprl_tpu_torch.sebulba", [*base, f"log_root={tmp}/abandon", "distributed.max_actor_respawns=0"],
                    child_env(SHEEPRL_TPU_SEBULBA_SUMMARY=tmp / "abandon.json"))
    outs = run_ok([respawned, abandoned], timeout=180)
    return {"tmp": tmp, "respawn": summary(tmp / "respawn.json"), "abandon": summary(tmp / "abandon.json"), "outs": outs}


def test_actor_sigkill_learner_keeps_stepping(runs):
    s = runs["respawn"]
    events = s["events"]  # [t, actor_id, generation, event]
    kill_t = next(t for t, a, g, e in events if a == 0 and g == 0 and e == "closed")
    respawn_t = next(t for t, a, g, e in events if a == 0 and g == 1 and e == "connected")
    assert respawn_t > kill_t
    assert any(a == 0 and g == 1 and e == "done" for _, a, g, e in events), events
    assert any(a == 1 and e == "done" for _, a, g, e in events), events
    inside = [(t, g) for t, g in s["grad_step_trace"] if kill_t < t < respawn_t]
    assert len(inside) >= 2, f"the learner starved in the kill window [{kill_t:.2f}, {respawn_t:.2f}]: {s['grad_step_trace']}"
    counts = [g for _, g in inside]
    assert all(b > a for a, b in zip(counts, counts[1:])), counts
    assert s["cumulative_grad_steps"] >= counts[-1] and s["error"] is None
    # the respawn logged under its generation, and reported its launch counts
    assert set(s["actors"]) == {"0_g1", "1_g0"}
    assert "actor0 died rc=-9; respawn 1/3" in runs["outs"][0]
    logs = {p.name for p in (runs["tmp"] / "respawn" / "runs" / "sac_decoupled").glob("*/*")}
    assert any(n.endswith("_actor0") for n in logs) and any(n.endswith("_actor0_g1") for n in logs), logs


def test_spent_respawn_budget_abandons_the_slot(runs):
    s = runs["abandon"]
    kinds = [(a, g, e) for _, a, g, e in s["events"]]
    assert (0, 0, "closed") in kinds and (0, -1, "abandoned") in kinds and (1, 0, "done") in kinds
    assert not any(a == 0 and g == 1 for a, g, _ in kinds)
    assert s["error"] is None and s["cumulative_grad_steps"] > 0
    assert "respawn budget (0) exhausted, abandoning slot" in runs["outs"][1]


def test_sigterm_ends_the_learner_with_a_checkpoint_and_exit_75(tmp_path):
    run = Run("sheeprl_tpu_torch.sebulba", [*KILL_SAC[:-2], *PORT_CPU, *QUIET_LOG, "algo.total_steps=1000000",
                                            "checkpoint.every=16", "checkpoint.keep_last=2", f"log_root={tmp_path}"],
              child_env(SHEEPRL_TPU_SEBULBA_SUMMARY=tmp_path / "summary.json"))
    deadline = time.monotonic() + 120
    while not list(tmp_path.rglob("ckpt_*")):  # the learner is in its loop
        assert run.proc.poll() is None and time.monotonic() < deadline, run.output()[-4000:]
        time.sleep(0.2)
    os.kill(run.proc.pid, signal.SIGTERM)
    rc, out = run.wait(timeout=60)
    assert rc == 75, out[-4000:]
    s = summary(tmp_path / "summary.json")
    # the learner ends at the training guard's boundary (Preempted, which its train entry
    # turns into exit 75), as the reference's learner does, with the PREEMPTED marker
    assert s["error"]["type"] == "Preempted" and s["checkpoint"].endswith(f"ckpt_{s['policy_step']}")
    assert os.path.isdir(s["checkpoint"]) and "learner exited rc=75" in out
    marker = json.loads((Path(s["checkpoint"]).parent.parent / "PREEMPTED").read_text())
    assert marker["step"] == s["policy_step"] and marker["resume_from"] == s["checkpoint"] and marker["signal"] == "SIGTERM"
