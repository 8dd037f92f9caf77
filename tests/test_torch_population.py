"""The PyTorch port's population Anakin (``engine/population.py`` and the engine's
members) against the JAX package's ``engine/population.py``, and its bit-for-bit
contracts.

* ``PopulationSpec`` raises the reference's errors on the same configs and reads the
  same specs; ``vectorize=True`` (not ported) raises, naming the key.
* ``population_rows`` and ``AnakinFutures.drain`` equal the reference's on the same
  numpy inputs (scalar and member-axis metrics, members without a finished episode).
* A population of one (an ``ent_coef`` sweep of one value) equals the plain run bit for
  bit, through the train entry; member 0 of a SAC population equals the plain SAC run.
* Each member of a 3-member population equals its standalone run bit for bit (PPO:
  two iterations; SAC: a prefill and a training dispatch), each from the member's own
  starting carry: nothing leaks across members, the rings' views included.
* An ``ent_coef`` sweep touches only the swept inputs; a member at learning rate 0 keeps
  its parameters (PPO), its critic (SAC).

Every run is on the CPU at the reference test's tiny shapes.
"""

import numpy as np
import pytest
import torch

PPO_ARGS = [
    "exp=ppo_anakin", "algo.rollout_steps=8", "algo.per_rank_batch_size=8", "algo.update_epochs=1", "algo.dense_units=8",
    "algo.mlp_layers=1", "algo.encoder.mlp_features_dim=8", "env.num_envs=2", "algo.total_steps=32",
]
SAC_ARGS = [
    "exp=sac_anakin", "algo.hidden_size=8", "algo.per_rank_batch_size=8", "algo.learning_starts=6", "algo.total_steps=14",
    "algo.anakin_steps_per_dispatch=4", "buffer.size=16", "env.num_envs=2",
]


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def cfgs(base, extra=()):
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.config.core import compose

    return jax_compose(overrides=[*base, *extra]), compose(overrides=[*base, *extra, "device=cpu", "mesh.precision=32-true"])


# --------------------------------------------------------------------------- spec and metrics


@pytest.mark.parametrize(
    "base,extra",
    [
        (PPO_ARGS, ["algo.population.size=-1"]),
        (PPO_ARGS, ["algo.population.size=2", "algo.population.sweep.gamma=[0.9,0.99]"]),
        (PPO_ARGS, ["algo.population.size=2", "algo.population.sweep.ent_coef=0.1"]),
        (PPO_ARGS, ["algo.population.size=3", "algo.population.sweep.ent_coef=[0.0,0.1]"]),
        (SAC_ARGS, ["algo.population.size=2", "algo.population.sweep.optimizer.lr=[0.1,0.2]"]),
        (SAC_ARGS, ["algo.population.size=2", "algo.population.sweep.critic.optimizer.lr=[0.1]"]),
    ],
)
def test_population_spec_raises_the_reference_errors(base, extra):
    from sheeprl_tpu.engine.population import PopulationSpec as JaxSpec
    from sheeprl_tpu_torch.engine.population import PopulationSpec

    jcfg, tcfg = cfgs(base, extra)
    algo = "ppo" if base is PPO_ARGS else "sac"
    with pytest.raises(ValueError) as want:
        JaxSpec.from_cfg(jcfg, algo)
    with pytest.raises(ValueError) as got:
        PopulationSpec.from_cfg(tcfg, algo)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "base,extra",
    [
        (PPO_ARGS, []),
        (PPO_ARGS, ["algo.population.size=3", "algo.population.sweep.ent_coef=[0.0,0.1,0.2]", "algo.population.sweep.optimizer.lr=[1e-3,0,2e-3]"]),
        (SAC_ARGS, ["algo.population.size=2", "algo.population.sweep.critic.optimizer.lr=[0.1,0.2]"]),
        (["exp=ppo_anakin_pop"], []),
        (["exp=sac_anakin_pop"], []),
    ],
)
def test_population_spec_reads_the_reference_specs(base, extra):
    from sheeprl_tpu.engine.population import PopulationSpec as JaxSpec
    from sheeprl_tpu_torch.engine.population import PopulationSpec, population_spec

    jcfg, tcfg = cfgs(base, extra)
    algo = "sac" if "sac" in base[0] else "ppo"
    want, got = JaxSpec.from_cfg(jcfg, algo), population_spec(tcfg, algo)
    assert (got.size, got.vectorize, got.sweep, got.enabled) == (want.size, want.vectorize, want.sweep, want.enabled)
    assert got.values("ent_coef", 0.5) == want.values("ent_coef", 0.5)
    _, vec = cfgs(base, [*extra, "algo.population.vectorize=True"])
    assert PopulationSpec.from_cfg(vec, algo).vectorize
    with pytest.raises(NotImplementedError, match=r"algo\.population\.vectorize"):
        population_spec(vec, algo)


def test_population_rows_match_the_reference():
    from sheeprl_tpu.engine.population import population_rows as jax_rows
    from sheeprl_tpu_torch.engine.population import population_rows

    rng = np.random.default_rng(0)
    for key in ("Loss/value_loss", "Rewards/rew_avg", "Game/ep_len_avg", "Episodes/count", "Health/x", "Params/lr"):
        vals = rng.normal(0, 3, 5)
        vals[2] = np.nan
        assert population_rows(key, vals) == jax_rows(key, vals)
    assert population_rows("Loss/x", np.full(3, np.nan)) == jax_rows("Loss/x", np.full(3, np.nan)) == {}


@pytest.mark.parametrize("members", [0, 4])
def test_futures_drain_matches_the_reference(members):
    from sheeprl_tpu.engine.anakin import AnakinFutures as JaxFutures
    from sheeprl_tpu.utils.metric import MetricAggregator as JaxAggregator
    from sheeprl_tpu_torch.engine.anakin import AnakinFutures
    from sheeprl_tpu_torch.utils.metric import make_aggregator

    rng = np.random.default_rng(members)
    shape = (members,) if members else ()
    keys = ("Loss/policy_loss", "Loss/value_loss", "Episodes/return_sum", "Episodes/len_sum", "Episodes/count")
    trees = []
    for _ in range(3):
        tree = {k: rng.normal(0, 2, shape).astype(np.float32) for k in keys[:2]}
        count = rng.integers(0, 3, shape).astype(np.float32)
        if members:
            count[1] = 0.0  # a member without a finished episode in the window
        tree.update({"Episodes/return_sum": (count * rng.uniform(5, 50, shape)).astype(np.float32),
                     "Episodes/len_sum": (count * rng.integers(5, 50, shape)).astype(np.float32), "Episodes/count": count})
        trees.append(tree)
    jf, tf = JaxFutures(), AnakinFutures()
    jagg, tagg = JaxAggregator({}), make_aggregator({})
    for tree in trees:
        jf.track({k: np.array(v) for k, v in tree.items()}, 16, 4)
        tf.track({k: torch.from_numpy(np.array(v)) for k, v in tree.items()}, 16, 4)
    want, got = jf.drain(jagg), tf.drain(tagg)
    assert set(want) == set(got) and {"Time/sps_env_interaction", "Time/sps_train"} <= set(got)
    for k, v in want.items():
        if not k.startswith("Time/"):
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
    jout, tout = jagg.compute(), tagg.compute()
    assert set(jout) == set(tout) and "Rewards/rew_avg" in tout
    for k, v in jout.items():
        np.testing.assert_allclose(tout[k], v, rtol=1e-6, err_msg=k)
    assert tf.drain(None) == {}  # an empty window fetches nothing


# --------------------------------------------------------------------------- bit for bit


def flat_carry(carry) -> list:
    from sheeprl_tpu_torch.utils.graphs import tree_tensors

    return [t.detach().clone() for t in tree_tensors(carry)]


def assert_carries_equal(a, b, what: str) -> None:
    fa, fb = flat_carry(a), flat_carry(b)
    assert len(fa) == len(fb)
    for i, (x, y) in enumerate(zip(fa, fb)):
        assert torch.equal(x, y), f"{what}: leaf {i}"


def test_population_of_one_equals_the_plain_run(tmp_path, monkeypatch):
    """Through the train entry: a one-member ``ent_coef`` sweep of the config's own value
    against the plain run; the last checkpoint's carries equal bit for bit."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.engine.population import slice_member

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    common = [*PPO_ARGS, "device=cpu", "mesh.precision=32-true", "algo.run_test=False", "checkpoint.every=16", "metric.log_every=16"]
    plain = run([*common, f"log_root={tmp_path / 'plain'}"])
    pop = run([*common, "algo.population.sweep.ent_coef=[0.0]", f"log_root={tmp_path / 'pop'}"])
    a, b = CheckpointManager.load(plain.checkpoint), CheckpointManager.load(pop.checkpoint)
    assert b["carry"]["obs"].shape[0] == 1 and a["update"] == b["update"] == 2
    assert_carries_equal(a["carry"], slice_member(b["carry"], 0), "population of one")


def ppo_population(extra=(), seed: int = 0, capture: bool = True):
    from sheeprl_tpu_torch.engine.anakin import anakin_env, build_ppo_members
    from sheeprl_tpu_torch.engine.population import population_spec
    from sheeprl_tpu_torch.parallel.context import RunContext

    _, cfg = cfgs(PPO_ARGS, extra)
    env, params = anakin_env(cfg)
    members, tables = build_ppo_members(RunContext(torch.device("cpu"), seed, torch.float32), cfg, env, params, "state", 4, population_spec(cfg, "ppo"), capture)
    return cfg, members, tables


def sac_population(extra=(), seed: int = 0):
    from sheeprl_tpu_torch.engine.anakin import anakin_env, build_sac_members
    from sheeprl_tpu_torch.engine.population import population_spec
    from sheeprl_tpu_torch.parallel.context import RunContext

    _, cfg = cfgs(SAC_ARGS, extra)
    env, params = anakin_env(cfg)
    return cfg, build_sac_members(RunContext(torch.device("cpu"), seed, torch.float32), cfg, env, params, "state", population_spec(cfg, "sac"))


def sac_run(member) -> None:
    member.dispatch(3, 0, False)
    member.dispatch(4, 1, True)


def test_ppo_members_equal_their_standalone_runs():
    _, members, tables = ppo_population(["algo.population.size=3"])
    starts = [flat_carry(m.carry()) for m in members]
    assert not torch.equal(starts[0][0], starts[1][0])  # distinct inits
    for update in range(2):
        for m, member in enumerate(members):
            member.iterate(tables[m][update])
    for m, member in enumerate(members):
        _, (alone,), alone_tables = ppo_population(seed=7)
        alone.load_carry(_as_carry(member, starts[m]))
        for update in range(2):
            alone.iterate(alone_tables[0][update])
        assert_carries_equal(member.carry(), alone.carry(), f"member {m}")


def _as_carry(member, flat) -> dict:
    """``flat`` (the leaves of ``member.carry()``) back in the carry's tree."""
    from sheeprl_tpu_torch.utils.graphs import tree_tensors

    carry = member.carry()
    leaves = iter(flat)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v) for v in tree)
        return next(leaves) if isinstance(tree, torch.Tensor) else tree

    out = rebuild(carry)
    assert len(tree_tensors(out)) == len(flat)
    return out


def test_sac_members_equal_their_standalone_runs_and_the_plain_run():
    _, members = sac_population(["algo.population.size=3"])
    starts = [flat_carry(m.carry()) for m in members]
    assert members[1].arrays["obs"].data_ptr() != members[0].arrays["obs"].data_ptr()
    for member in members:
        sac_run(member)
    assert int(members[2].rows_added) == 7 and int(members[2].gstep) == 4
    for m, member in enumerate(members):
        _, (alone,) = sac_population(seed=7)
        alone.load_carry(_as_carry(member, starts[m]))
        sac_run(alone)
        assert_carries_equal(member.carry(), alone.carry(), f"member {m}")
    # member 0 continues the plain run's draws: the plain run from scratch equals it
    _, (plain,) = sac_population()
    sac_run(plain)
    assert_carries_equal(members[0].carry(), plain.carry(), "member 0 against the plain run")


def test_ent_coef_sweep_touches_only_the_swept_member():
    _, members, tables = ppo_population(["algo.population.size=3", "algo.population.sweep.ent_coef=[0.0,0.0,0.3]"])
    for m in range(3):
        np.testing.assert_array_equal(tables[m][:, 0].numpy(), tables[0][:, 0].numpy())
        assert float(tables[m][0, 1]) == pytest.approx([0.0, 0.0, 0.3][m])
    start = flat_carry(members[0].carry())
    for member in members:  # one starting carry for all: only the swept input differs
        member.load_carry(_as_carry(member, start))
    for m, member in enumerate(members):
        member.iterate(tables[m][0])
    assert_carries_equal(members[0].carry(), members[1].carry(), "equal ent_coef")
    moved = [not torch.equal(a, b) for a, b in zip(members[0].agent.parameters(), members[2].agent.parameters())]
    assert any(moved)
    assert torch.equal(members[0].obs, members[2].obs)  # the same rollout: the sweep reaches the update only
    assert torch.equal(members[0].traj["actions"], members[2].traj["actions"])


def test_member_at_lr_zero_keeps_its_parameters():
    _, members, tables = ppo_population(["algo.population.size=2", "algo.population.sweep.optimizer.lr=[0.001,0.0]"])
    assert float(members[1].fns.opt_state["lr"]) == 0.0 and float(members[0].fns.opt_state["lr"]) == pytest.approx(1e-3)
    before = [[p.detach().clone() for p in m.agent.parameters()] for m in members]
    for m, member in enumerate(members):
        member.iterate(tables[m][0])
    assert all(torch.equal(a, b) for a, b in zip(before[1], members[1].agent.parameters()))
    assert not all(torch.equal(a, b) for a, b in zip(before[0], members[0].agent.parameters()))
    assert int(members[1].fns.opt_state["count"]) == members[1].fns.grad_steps_per_update
    _, sac = sac_population(["algo.population.size=2", "algo.population.sweep.critic.optimizer.lr=[0.0003,0.0]"])
    critic_before = [p.detach().clone() for p in sac[1].agent.critic.parameters()]
    actor_before = [p.detach().clone() for p in sac[1].agent.actor.parameters()]
    for member in sac:
        sac_run(member)
    assert all(torch.equal(a, b) for a, b in zip(critic_before, sac[1].agent.critic.parameters()))
    assert not all(torch.equal(a, b) for a, b in zip(actor_before, sac[1].agent.actor.parameters()))
    assert "lr" in sac[0].opt_states["critic"] and "lr" not in sac[0].opt_states["actor"]


def test_lr_sweep_refuses_an_annealed_lr():
    """As the reference's: a swept learning rate is a member's constant in its optimizer
    state, which a schedule cannot be."""
    from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer, polynomial_schedule

    with pytest.raises(ValueError, match=r"algo\.anneal_lr=True cannot combine with a population learning-rate sweep"):
        ppo_population(["algo.population.size=2", "algo.population.sweep.optimizer.lr=[0.001,0.0]", "algo.anneal_lr=True"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_optimizer({"name": "adam", "lr": 1e-3}, 0.0, polynomial_schedule(1e-3, 1e-8, 1.0, 10), inject_lr=True)
