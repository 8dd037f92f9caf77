"""``ppo_decoupled`` with ``distributed.mode=sebulba`` on the CPU: one learner process
and one actor process on the reference smoke's tiny PPO overrides
(``tests/test_distributed/test_sebulba_smoke.py``), beside the port's thread path on the
same overrides. The placement is a pure topology change: the learner consumes the thread
path's batches byte for byte (``SHEEPRL_TPU_BATCH_DIGEST``, 4 of 4 lines) and ends on
its parameters and optimizer state bit for bit. The placed run starts from the train
entry itself (``python -m sheeprl_tpu_torch ... distributed.mode=sebulba``: the entry
becomes the launcher)."""

import pytest
import torch

from tests.torch_sebulba_common import PORT_CPU, PPO_OVERRIDES, QUIET_LOG, Run, child_env, run_ok, summary


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sebulba_ppo")
    base = [*PPO_OVERRIDES, *PORT_CPU, *QUIET_LOG]
    thread = Run("sheeprl_tpu_torch", [*base, f"log_root={tmp}/thread"], child_env(SHEEPRL_TPU_BATCH_DIGEST=tmp / "thread.digest"))
    placed = Run("sheeprl_tpu_torch", [*base, f"log_root={tmp}/sebulba", "distributed.mode=sebulba", "distributed.num_actors=1",
                                       "distributed.connect_timeout_s=30"],
                 child_env(SHEEPRL_TPU_BATCH_DIGEST=tmp / "sebulba.digest", SHEEPRL_TPU_SEBULBA_SUMMARY=tmp / "summary.json"))
    outs = run_ok([thread, placed], timeout=180)
    return {"tmp": tmp, "summary": summary(tmp / "summary.json"), "out": outs[1]}


def test_learner_consumes_the_thread_paths_batches(runs):
    tmp = runs["tmp"]
    thread = (tmp / "thread.digest").read_text().splitlines()
    placed = (tmp / "sebulba.digest").read_text().splitlines()
    # 64 total steps / (2 envs x 8 rollout steps): 4 updates in both placements
    assert len(thread) == 4 and [line.split()[0] for line in thread] == [f"ppo:{u}" for u in range(1, 5)]
    assert placed == thread


def test_learner_ends_on_the_thread_paths_state(runs):
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager

    tmp = runs["tmp"]
    last = {}
    for name in ("thread", "sebulba"):
        ckpts = sorted((tmp / name).rglob("ckpt_64"))
        assert len(ckpts) == 1, ckpts
        last[name] = CheckpointManager.load(ckpts[0])
    for key, value in last["thread"]["params"].items():
        assert torch.equal(value, last["sebulba"]["params"][key]), key
    flat = lambda tree: [t for v in tree.values() for t in (flat(v) if isinstance(v, dict) else [v]) if torch.is_tensor(t)]  # noqa: E731
    for a, b in zip(flat(last["thread"]["opt_state"]), flat(last["sebulba"]["opt_state"]), strict=True):
        assert torch.equal(a, b)
    assert last["sebulba"]["update"] == 4 and last["sebulba"]["policy_step"] == 64


def test_lockstep_publishes_after_every_block(runs):
    s = runs["summary"]
    # one publication per consumed block keeps the actor one to one with the thread player's wait
    assert s["error"] is None and s["blocks"] == 4 and s["publishes"] == 4 and s["env_steps_total"] == 64
    assert s["cumulative_grad_steps"] == 4 * 2  # update_epochs 1 x (16 rows / minibatches of 8)
    # the actor acted with the parameters of the update before each of its blocks
    assert s["staleness_steps"]["n"] == 3 and s["staleness_steps"]["max"] == 16
    assert "[sebulba] spawning learner" in runs["out"] and "[sebulba] learner exited rc=0" in runs["out"]
