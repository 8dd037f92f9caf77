"""``ppo_decoupled`` of the PyTorch port on the CPU, at tiny sizes, and what the two
decoupled entries share: the publication helpers, the batch digest, the CLI's decoupled
check and multirun sweeps.

* The publication helpers against the JAX package's (``make_stamp``,
  ``staleness_steps``, ``evict_and_put``), and ``tree_digest``/``maybe_digest`` of one
  numpy tree equal to the reference's hex strings (a tree of tensors hashes alike).
* Against the port's own coupled ``ppo`` at ``rollout.pipeline_depth=0``, fed the same
  draws: the same parameters, Adam state and count, and logged losses after three
  updates, exactly (tolerance 0: the same operations on the same inputs on the CPU). The
  reference's two entries compute the same update from the same rollout: they differ
  only in where the player's draws come from and in the logged
  ``Sebulba/param_staleness_steps`` (and the coupled entry's ``Rollout/*`` counters of
  an env pool, which the port's envs do not keep).
* Against the JAX package's ``ppo_decoupled`` on the same tiny config (one reference
  run): the same updates, gradient steps, policy steps, checkpoint names and keys, and
  logged metric names, the reference's observability families left out.
* Train, resume from a middle checkpoint and evaluate through ``sheeprl_tpu_torch.eval``.
* ``expand_multirun`` on the reference's cases, and a two-job ``-m`` sweep.
* The configs the reference's CLI refuses or accepts (its decoupled check among them),
  through ``tests/test_torch_dv1_cli.py::check_both``, and the keys each decoupled entry
  refuses, naming the key.

Every run that starts a player thread goes through ``bounded`` (a join with a timeout of
its own)."""

import glob
import queue
from pathlib import Path

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
from tests.test_torch_sac_decoupled import Recorder, bounded, player_threads

TINY = ["algo.rollout_steps=8", "algo.per_rank_batch_size=8", "algo.update_epochs=2", "algo.dense_units=8", "algo.mlp_layers=1",
        "algo.total_steps=64", "env.num_envs=2", "env.sync_env=True", "env.capture_video=False", "checkpoint.every=32",
        "metric.log_every=16", "env.max_episode_steps=3"]
PORT = ["exp=ppo_decoupled", "device=cpu", *TINY]
REFERENCE = ["exp=ppo_decoupled", "env=discrete_dummy", "algo.mlp_keys.encoder=[state]", *TINY]
# three updates with every annealing on and an entropy term
PARITY = ["exp=ppo_decoupled", "device=cpu", *TINY, "algo.total_steps=48", "algo.anneal_lr=True", "algo.anneal_clip_coef=True",
          "algo.anneal_ent_coef=True", "algo.ent_coef=0.01", "algo.normalize_advantages=True", "algo.clip_vloss=True",
          "algo.max_grad_norm=0.5", "algo.run_test=False", "checkpoint.every=16"]


@pytest.fixture(autouse=True)
def few_threads(monkeypatch):
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    yield
    torch.set_num_threads(before)


@pytest.fixture
def port_log(monkeypatch):
    """The PPO family's loops log into a ``Recorder`` (and import no tensorboard)."""
    import sheeprl_tpu_torch.algos.ppo.ppo as ppo

    log = Recorder()
    monkeypatch.setattr(ppo, "get_logger", lambda cfg, log_dir: log)
    return log


# --------------------------------------------------------------------------- helpers


def test_publication_helpers_match_the_reference():
    from sheeprl_tpu.distributed import publish as ref
    from sheeprl_tpu_torch.distributed import publish as port

    assert port.make_stamp(3, 40, 128) == ref.make_stamp(3, 40, 128)
    for stamp, step in ((None, 5), ({}, 5), ({"policy_step": 8}, 20), ({"policy_step": 30}, 20), ({"seq": 1}, 7)):
        assert port.staleness_steps(stamp, step) == ref.staleness_steps(stamp, step)
    for mod in (ref, port):
        q = queue.Queue(maxsize=2)
        assert [mod.evict_and_put(q, i) for i in range(5)] == [0, 0, 1, 1, 1]
        assert [q.get_nowait() for _ in range(2)] == [3, 4]

    # on the CPU a hand-off carries no event; a publication is a copy, adopted in place
    src = [torch.arange(4.0), torch.ones(2, 3)]
    pub = port.publish(src, port.make_stamp(1, 2, 3))
    assert pub.event is None and port.ready(pub) and pub.stamp == {"seq": 1, "grad_step": 2, "policy_step": 3}
    src[0].add_(100.0)
    dst = [torch.zeros(4), torch.zeros(2, 3)]
    port.adopt(pub, dst)
    assert torch.equal(dst[0], torch.arange(4.0)) and torch.equal(dst[1], torch.ones(2, 3))
    assert port.receive(port.handoff([], torch.device("cpu")), torch.device("cpu")) == []

    # the player adopts the newest publication whose copy has finished; events of one
    # stream finish in order
    class Event:
        def __init__(self, done):
            self.done = done

        def query(self):
            return self.done

    pending = [port.Publication([], Event(d), {"seq": i}) for i, d in enumerate((True, True, False))]
    assert port.take_newest_ready(pending).stamp == {"seq": 1} and [p.stamp["seq"] for p in pending] == [2]
    assert port.take_newest_ready(pending) is None and len(pending) == 1
    pending[0].event.done = True
    assert port.take_newest_ready(pending).stamp == {"seq": 2} and pending == []


def test_tree_digest_matches_the_reference(tmp_path, monkeypatch):
    import ml_dtypes
    from sheeprl_tpu.distributed import transport as ref
    from sheeprl_tpu_torch.distributed import transport as port

    rng = np.random.default_rng(0)
    tree = {"obs": rng.normal(size=(2, 4, 5)).astype(np.float32), "rgb": rng.integers(0, 255, (3, 2, 2), dtype=np.uint8),
            "nested": [np.arange(3, dtype=np.int64), (np.float32(1.5), None)], "half": np.ones(3, ml_dtypes.bfloat16)}
    assert port.tree_digest(tree) == ref.tree_digest(tree)
    as_tensors = {"obs": torch.from_numpy(tree["obs"]), "rgb": torch.from_numpy(tree["rgb"]),
                  "nested": [torch.arange(3), (np.float32(1.5), None)], "half": torch.ones(3, dtype=torch.bfloat16)}
    assert port.tree_digest(as_tensors) == ref.tree_digest(tree)

    assert port.BATCH_DIGEST_ENV_VAR == ref.BATCH_DIGEST_ENV_VAR
    port.maybe_digest("ppo:1", tree)  # unarmed: writes nothing
    for mod, name in ((ref, "ref.txt"), (port, "port.txt")):
        monkeypatch.setenv(mod.BATCH_DIGEST_ENV_VAR, str(tmp_path / name))
        mod.maybe_digest("ppo:1", tree)
        mod.maybe_digest("ppo:2", {"x": tree["obs"][0]})
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "ref.txt").read_text()
    assert len((tmp_path / "port.txt").read_text().splitlines()) == 2


# --------------------------------------------------------------------------- the entry


def same_draws_as_decoupled(monkeypatch):
    """Make the coupled entry's generators those of ``ppo_decoupled``: ``ctx.rng()`` draw
    0 initialises the agent in both; the coupled entry's player (draw 1) gets the
    decoupled player's seed and its update (draw 2) the decoupled learner's (draw 1)."""
    from sheeprl_tpu_torch.algos.decoupled import PLAYER_SEED_OFFSET
    from sheeprl_tpu_torch.parallel.context import RunContext

    rng = RunContext.rng

    def reseeded(self, device=None):
        draw = self._draws
        gen = rng(self, device)
        if draw == 1:
            gen.manual_seed(self.seed + PLAYER_SEED_OFFSET)
        elif draw == 2:
            gen.manual_seed(self.seed * 1_000_003 + 1)
        return gen

    monkeypatch.setattr(RunContext, "rng", reseeded)


def test_decoupled_update_equals_the_coupled_one(tmp_path, monkeypatch, port_log):
    from sheeprl_tpu_torch.cli import run

    decoupled = bounded(run, [*PARITY, f"log_root={tmp_path / 'decoupled'}"])
    decoupled_log = list(port_log.logged)
    port_log.logged.clear()
    with monkeypatch.context() as m:
        same_draws_as_decoupled(m)
        coupled = bounded(run, [*PARITY, "algo.name=ppo", "rollout.pipeline_depth=0", f"log_root={tmp_path / 'coupled'}"])

    assert decoupled.policy_steps == coupled.policy_steps == 48 and decoupled.grad_steps == coupled.grad_steps == 12
    states = [CheckpointManager.load(r.checkpoint) for r in (decoupled, coupled)]
    assert [s["update"] for s in states] == [3, 3] and int(states[0]["opt_state"]["count"]) == 12
    for k, v in states[1]["params"].items():
        assert torch.equal(states[0]["params"][k], v), k
    opt = [s["opt_state"] for s in states]
    assert opt[0].keys() == opt[1].keys() and int(opt[0]["count"]) == int(opt[1]["count"])
    for key in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(opt[0][key], opt[1][key])), key
    losses = lambda logged: [(step, {k: v for k, v in m.items() if k.startswith("Loss/")}) for step, m in logged]  # noqa: E731
    assert len(decoupled_log) == 3 and losses(decoupled_log) == losses(port_log.logged)
    assert not player_threads()


def test_counts_checkpoints_and_metric_names_match_the_reference(tmp_path, monkeypatch, port_log):
    import sheeprl_tpu.algos.ppo.ppo_decoupled as jax_entry
    from sheeprl_tpu.checkpoint.manager import CheckpointManager as JaxCheckpointManager
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu_torch.cli import run

    jax_log = Recorder()
    monkeypatch.setattr(jax_entry, "get_logger", lambda cfg, log_dir: jax_log)
    bounded(jax_run, [*REFERENCE, f"log_root={tmp_path / 'jax'}"])
    result = bounded(run, [*PORT, f"log_root={tmp_path / 'port'}"])

    def summary(run_dir, manager):
        out = {}
        for path in manager(Path(run_dir) / "checkpoints").list_checkpoints():
            state = manager.load(path)
            out[path.name] = {"keys": sorted(state), **{k: int(state[k]) for k in ("update", "policy_step", "last_checkpoint")}}
        return out

    (jax_dir,) = (tmp_path / "jax").rglob("version_0")
    assert summary(result.log_dir, CheckpointManager) == summary(jax_dir, JaxCheckpointManager)
    # 4 updates of 2 epochs x 2 minibatches
    assert result.policy_steps == 64 and result.grad_steps == 16
    assert int(CheckpointManager.load(result.checkpoint)["opt_state"]["count"]) == 16
    assert port_log.names() == jax_log.names()
    # the first rollout acts with the initial parameters, which carry no stamp
    assert [("Sebulba/param_staleness_steps" in n) for _, n in port_log.names()] == [False, True, True, True, False]


def test_train_resume_evaluate(tmp_path, port_log):
    from sheeprl_tpu_torch.cli import evaluate, run

    first = bounded(run, [*PORT, f"log_root={tmp_path / 'first'}"])
    assert first.policy_steps == 64 and first.grad_steps == 16 and first.test_reward == 0.0
    ckpts = CheckpointManager(Path(first.log_dir) / "checkpoints").list_checkpoints()
    assert [p.name for p in ckpts] == ["ckpt_32", "ckpt_64"]

    resumed = bounded(run, [*PORT, f"log_root={tmp_path / 'resumed'}", f"checkpoint.resume_from={ckpts[0]}"])
    again = CheckpointManager.load(resumed.checkpoint)
    assert resumed.policy_steps == 64 and resumed.grad_steps == 8 and again["update"] == 4 and int(again["opt_state"]["count"]) == 16
    staleness = [m.get("Sebulba/param_staleness_steps") for _, m in port_log.logged if "Loss/policy_loss" in m]
    assert staleness[:4] == [None, 16.0, 16.0, 16.0]  # one rollout of lag, the first rollout unstamped

    result = evaluate([f"checkpoint_path={ckpts[-1]}", "device=cpu", "env.capture_video=False"])
    assert result.reward == 0.0 and result.steps >= 1
    assert not player_threads()


# --------------------------------------------------------------------------- the CLI


@pytest.mark.parametrize(
    "overrides",
    [
        ["algo.lr=1e-4,3e-4", "seed=1,2", "exp=ppo"],
        ["algo.cnn_keys.encoder=[rgb,depth]", "seed=3"],
        ["exp=sac", "seed='1,2'", "algo.per_rank_batch_size=64,128,256"],
        [],
    ],
)
def test_expand_multirun_matches_the_reference(overrides):
    from sheeprl_tpu.cli import expand_multirun as jax_expand
    from sheeprl_tpu_torch.cli import expand_multirun

    assert expand_multirun(overrides) == jax_expand(overrides)


def test_multirun_sweep_writes_one_run_per_job(tmp_path, port_log):
    from sheeprl_tpu_torch.cli import run

    results = run(["-m", "exp=ppo_dummy", "seed=1,2", "device=cpu", "dry_run=True", "algo.rollout_steps=8", "algo.per_rank_batch_size=8",
                   "algo.update_epochs=1", "algo.dense_units=8", "algo.mlp_layers=1", "algo.run_test=False", "env.num_envs=2",
                   "env.sync_env=True", "checkpoint.every=0", "checkpoint.save_last=False", f"log_root={tmp_path}"])
    run_dirs = sorted(glob.glob(f"{tmp_path}/**/multirun_*/job*/version_0", recursive=True))
    assert len(results) == 2 and len(run_dirs) == 2, run_dirs
    assert sorted(r.log_dir for r in results) == run_dirs
    cfgs = [open(f"{d}/config.yaml").read() for d in run_dirs]
    assert "seed: 1" in cfgs[0] and "seed: 2" in cfgs[1]


@pytest.mark.parametrize(
    "overrides,refused",
    [
        (["exp=sac_decoupled"], False),
        (["exp=ppo_decoupled"], False),
        (["exp=sac_decoupled", "env.num_envs=0"], True),
        (["exp=ppo_decoupled", "env.num_envs=0"], True),
        (["exp=ppo_decoupled", "env.num_envs=0", "env.sync_env=True"], False),
        (["exp=sac", "env.num_envs=0"], False),
        (["exp=ppo_decoupled", "metric.log_level=2"], True),
    ],
)
def test_config_checks_match_the_reference(overrides, refused):
    from tests.test_torch_dv1_cli import check_both

    jax_exc, port_exc = check_both(overrides)
    assert (jax_exc is not None) == (port_exc is not None) == refused, (jax_exc, port_exc)
    if refused:
        assert str(port_exc) == str(jax_exc)


@pytest.mark.parametrize(
    "exp,override,pattern",
    [
        ("sac_decoupled", "+distributed.mode=sebulba", r"distributed\.mode='sebulba': the reference's sac_decoupled then runs"),
        ("ppo_decoupled", "+distributed.mode=sebulba", r"distributed\.mode='sebulba': the reference's ppo_decoupled then runs"),
        ("ppo_dummy", "+distributed.mode=sebulba", r"distributed\.mode='sebulba': the ppo loop has no player/learner split"),
        ("sac_decoupled", "+obs.enabled=True", r"obs\.enabled"),
        ("ppo_decoupled", "+obs.health=True", r"obs\.health"),
        ("sac_decoupled", "+analysis.strict=True", r"analysis\.strict"),
        ("ppo_decoupled", "+fault.autoresume=True", r"fault\.autoresume"),
        ("ppo_decoupled", "buffer.memmap=True", r"buffer\.memmap"),
        ("sac_decoupled", "+mesh.data=2", r"mesh\.data"),
        ("ppo_decoupled", "+mesh.devices=4", r"mesh\.devices"),
        ("sac_decoupled", "rollout.pipeline_depth=1", r"the sac_decoupled loop acts synchronously, as the reference's does"),
        ("ppo_decoupled", "rollout.pipeline_depth=1", r"the ppo_decoupled loop acts synchronously, as the reference's does"),
    ],
)
def test_decoupled_entries_refuse_what_they_lack(tmp_path, exp, override, pattern):
    from sheeprl_tpu_torch.cli import run

    with pytest.raises(NotImplementedError, match=pattern):
        run([f"exp={exp}", override, "device=cpu", "env.sync_env=True", f"log_root={tmp_path}"])
    assert not player_threads()
