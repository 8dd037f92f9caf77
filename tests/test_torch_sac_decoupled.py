"""``sac_decoupled`` of the PyTorch port on the CPU, at tiny sizes: the player and the
learner as two threads.

* Against the JAX package's ``sac_decoupled`` on the same tiny config (one reference
  run): the same iterations, gradient steps, policy steps, checkpoint names and keys
  (``rb`` included with ``buffer.checkpoint=True``) and the same logged metric names,
  ``Sebulba/param_staleness_steps`` among them. The reference also logs the families
  of its observability plane (``Health/*``, ``Perf/*``, ``Time/phase_*``), which the
  port does not have yet; they are left out of the comparison.
* Train, resume from a middle checkpoint and evaluate through ``sheeprl_tpu_torch.eval``,
  with host replay and with ``buffer.device=True`` (the device ring, its writes and
  blocks ordered by the ``StreamFence``, a lock on the CPU).
* A player that raises surfaces its exception in the caller, and no thread is left.
* ``PlayerThread`` and ``StreamFence`` on their own.

Every run that starts a player thread goes through ``bounded``: it runs on a thread
joined with a timeout of its own and fails, rather than hangs, if the join runs out."""

import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from sheeprl_tpu_torch.algos.decoupled import PlayerThread, StreamFence
from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager

TINY = ["algo.hidden_size=8", "algo.per_rank_batch_size=4", "algo.learning_starts=8", "algo.total_steps=32", "buffer.size=32",
        "env.num_envs=2", "env.sync_env=True", "env.capture_video=False", "checkpoint.every=16", "metric.log_every=16",
        "env.max_episode_steps=5", "buffer.checkpoint=True"]
PORT = ["exp=sac_decoupled", "device=cpu", "env.wrapper.vector_shape=[5]", "env.wrapper.action_dim=2", *TINY]
REFERENCE = ["exp=sac_decoupled", "env=continuous_dummy", "algo.mlp_keys.encoder=[state]", "buffer.memmap=False", *TINY]
# the reference's observability plane, not ported yet
NOT_PORTED_FAMILIES = ("Health/", "Perf/", "Time/phase_")
BOUND_SECONDS = 120.0


@pytest.fixture(autouse=True)
def few_threads(monkeypatch):
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    yield
    torch.set_num_threads(before)


@pytest.fixture
def port_log(monkeypatch):
    """The port's entry logs into a ``Recorder`` (and imports no tensorboard)."""
    import sheeprl_tpu_torch.algos.sac.sac_decoupled as entry

    log = Recorder()
    monkeypatch.setattr(entry, "get_logger", lambda cfg, log_dir: log)
    return log


def bounded(fn, *args, seconds: float = BOUND_SECONDS):
    """``fn(*args)`` on a thread joined within ``seconds``: its result, or its exception
    raised here; a join that runs out fails the test."""
    out = {}

    def target():
        try:
            out["result"] = fn(*args)
        except BaseException as exc:  # re-raised in the test's thread
            out["error"] = exc

    t = threading.Thread(target=target, name="bounded-run", daemon=True)
    t.start()
    t.join(timeout=seconds)
    assert not t.is_alive(), f"the run did not end within {seconds} s"
    if "error" in out:
        raise out["error"]
    return out["result"]


def player_threads():
    return [t for t in threading.enumerate() if t.name.endswith("-player") and t.is_alive()]


class Recorder:
    """A logger that keeps what it was asked to log, by step."""

    def __init__(self):
        self.logged = []

    def log_metrics(self, metrics, step):
        self.logged.append((step, dict(metrics)))

    def close(self):
        pass

    def names(self):
        """The logged names by step, the reference's observability families left out."""
        return [(step, sorted(k for k in m if not k.startswith(NOT_PORTED_FAMILIES))) for step, m in self.logged]


def ckpt_summary(run_dir, manager=CheckpointManager):
    """Per checkpoint of a run (``manager``: the package's checkpoint manager): its
    keys, its buffer's and ratio's keys, and its counters."""
    out = {}
    for path in manager(Path(run_dir) / "checkpoints").list_checkpoints():
        state = manager.load(path)
        out[path.name] = {"keys": sorted(state), "rb": sorted(state["rb"]), "ratio": sorted(state["ratio"]),
                          **{k: int(state[k]) for k in ("iter_num", "policy_step", "cumulative_grad_steps", "last_checkpoint")}}
    return out


def test_counts_checkpoints_and_metric_names_match_the_reference(tmp_path, monkeypatch, port_log):
    import sheeprl_tpu.algos.sac.sac_decoupled as jax_entry
    from sheeprl_tpu.checkpoint.manager import CheckpointManager as JaxCheckpointManager
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu_torch.cli import run

    jax_log = Recorder()
    monkeypatch.setattr(jax_entry, "get_logger", lambda cfg, log_dir: jax_log)
    bounded(jax_run, [*REFERENCE, f"log_root={tmp_path / 'jax'}"])
    result = bounded(run, [*PORT, f"log_root={tmp_path / 'port'}"])

    (jax_dir,) = (tmp_path / "jax").rglob("version_0")
    assert ckpt_summary(result.log_dir) == ckpt_summary(jax_dir, JaxCheckpointManager)
    summary = ckpt_summary(result.log_dir)
    assert list(summary) == ["ckpt_16", "ckpt_32"] and summary["ckpt_32"]["cumulative_grad_steps"] == result.grad_steps == 26
    assert result.policy_steps == 32
    assert port_log.names() == jax_log.names()
    assert all("Sebulba/param_staleness_steps" in names for _, names in port_log.names() if names != ["Test/cumulative_reward"])
    assert not player_threads()


@pytest.mark.parametrize("device_replay", [False, True], ids=["host", "device"])
def test_train_resume_evaluate(tmp_path, port_log, device_replay):
    from sheeprl_tpu_torch.cli import evaluate, run

    extra = ["buffer.device=True"] if device_replay else []
    first = bounded(run, [*PORT, *extra, f"log_root={tmp_path / 'first'}"])
    # 16 iterations of 2 envs; gradient steps from iteration 4 on, offset by the 3 prefill iterations
    assert first.policy_steps == 32 and first.grad_steps == 26 and first.test_reward == 0.0
    assert first.env_seconds > 0 and first.train_seconds > 0
    ckpts = CheckpointManager(Path(first.log_dir) / "checkpoints").list_checkpoints()
    state = CheckpointManager.load(ckpts[-1])
    assert int(state["opt_state"]["critic"]["count"]) == state["cumulative_grad_steps"] == 26
    assert state["rb"]["full"] and state["rb"]["pos"] == 0

    resumed = bounded(run, [*PORT, *extra, f"log_root={tmp_path / 'resumed'}", f"checkpoint.resume_from={ckpts[0]}"])
    again = CheckpointManager.load(resumed.checkpoint)
    # the first checkpoint's 10 steps, then the resumed run's: the governor catches up
    assert resumed.policy_steps == 32 and again["iter_num"] == 16 and resumed.grad_steps > 0
    assert int(again["opt_state"]["critic"]["count"]) == again["cumulative_grad_steps"] == 10 + resumed.grad_steps == 26

    result = evaluate([f"checkpoint_path={ckpts[-1]}", "device=cpu", "env.capture_video=False"])
    assert result.reward == 0.0 and result.steps >= 1
    assert not player_threads()


def test_a_player_that_raises_surfaces_in_the_caller(tmp_path, monkeypatch, port_log):
    import sheeprl_tpu_torch.algos.sac.sac_decoupled as entry
    from sheeprl_tpu_torch.cli import run

    make = entry.make_vector_env

    def failing_envs(*args, **kwargs):
        envs = make(*args, **kwargs)
        step, calls = envs.step, [0]

        def step_then_fail(actions):
            calls[0] += 1
            if calls[0] > 6:
                raise RuntimeError("env step failed in the player")
            return step(actions)

        envs.step = step_then_fail
        return envs

    monkeypatch.setattr(entry, "make_vector_env", failing_envs)
    with pytest.raises(RuntimeError, match="env step failed in the player"):
        bounded(run, [*PORT, f"log_root={tmp_path}"])
    assert not player_threads()


def test_player_thread_hands_items_over_and_stops():
    def body(thread):
        for i in range(3):
            if not thread.put(i):
                return
        raise ValueError("after three items")

    player = PlayerThread("test-player", body, torch.device("cpu"))
    player.start()
    try:
        assert [player.take() for _ in range(3)] == [0, 1, 2]
        with pytest.raises(ValueError, match="after three items"):
            player.take()
    finally:
        player.close()
    player.check_closed()

    # a body blocked on a full queue returns once stopped; ``take`` on a body that ended
    # without its items raises instead of waiting
    blocked = PlayerThread("test-player", lambda t: [t.put(i) for i in range(10)], torch.device("cpu"))
    blocked.start()
    time.sleep(0.2)
    blocked.close()
    blocked.check_closed()
    quiet = PlayerThread("test-player", lambda t: None, torch.device("cpu"))
    quiet.start()
    with pytest.raises(RuntimeError, match="ended before its last item"):
        quiet.take()
    quiet.close()
    assert not player_threads()


def test_stream_fence_orders_its_holders_on_the_cpu():
    """Four threads append under the fence with a short switch interval; each holder's
    pair of writes lands whole."""
    fence, rows = StreamFence(), []

    def writer(tag):
        for i in range(200):
            with fence.hold(None):
                rows.append((tag, i))
                rows.append((tag, i))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=writer, args=(tag,)) for tag in "abcd"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(rows) == 1600 and all(rows[i] == rows[i + 1] for i in range(0, 1600, 2))
