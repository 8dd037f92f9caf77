"""The PyTorch port's Anakin SAC dispatch (``engine/anakin.py::SACAnakin``) against the
JAX package's ``make_sac_anakin_dispatch``.

Both packages build the reference test's tiny SAC (``tests/test_algos/test_anakin.py``:
batched Pendulum, 2 envs, MLPs of width 8, batch 8), here with ``replay_ratio=2`` and
``target_network_frequency=2``, over a ring of 8 rows per env, the JAX parameters
(perturbed) carried into the port. From the same env reset both run a prefill dispatch
of 6 iterations (uniform env actions) and a training dispatch of 4 (the ring wraps),
the port handed the draws the reference's key chain makes (``reference_draws``: per
iteration ``split(key, 3)``; the acting noise or the env's uniform actions from
``k_act``; the envs' reset draws from ``k_step``; per gradient step the ring indices
from ``k_sample`` and the update's two normals from ``k_update``).

Compared: the ring's rows, ``rows_added``, ``gstep`` and the env state; every
parameter and Adam moment and the losses at ``tests/test_torch_sac_train.py``'s ``F32``
limits. Also the ring counters' round trip through ``CheckpointManager`` (and a carry
without its ring restarting replay from empty), and the fractional-``replay_ratio``,
Box-action and no-batched-env errors.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_anakin_ppo import reset_values
from tests.test_torch_sac_train import F32, assert_opt_states_match, assert_params_match

ARGS = [
    "exp=sac", "env=jax_pendulum", "algo.anakin=True", "algo.mlp_keys.encoder=[state]", "algo.hidden_size=8",
    "algo.per_rank_batch_size=8", "algo.learning_starts=8", "algo.total_steps=64", "algo.anakin_steps_per_dispatch=8",
    "buffer.size=16", "env.num_envs=2", "env.capture_video=False", "buffer.memmap=False", "mesh.precision=32-true",
    "algo.replay_ratio=2", "algo.critic.target_network_frequency=2",
]
N, B, A, CAP, G = 2, 8, 1, 8, 2
PREFILL, STEPS = 6, 4
RING_ATOL = 1e-5


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def reference_draws(jenv, jp, key, steps: int, train: bool, rows_added: int):
    """The draws of one reference dispatch of ``steps`` iterations from its carried
    ``key`` (``rows_added`` rows in the ring before it), in the port's injected layout."""
    out = {"act": [], "reset": [], "envs": [], "rows": [], "next": [], "new": []}
    low, high = jp.max_torque * -1.0, jp.max_torque
    for s in range(steps):
        key, k_act, k_step = jax.random.split(key, 3)
        if train:
            out["act"].append(np.asarray(jax.random.normal(k_act, (N, A))))
        else:
            out["act"].append(np.stack([np.asarray(jax.random.uniform(k, (A,), jnp.float32, low, high)) for k in jax.random.split(k_act, N)]))
        step_keys = jax.random.split(k_step, N)
        out["reset"].append(reset_values(jenv, jp, jax.vmap(lambda k: jax.random.split(k)[1])(step_keys)))
        if train:
            filled = min(rows_added + s + 1, CAP)
            key, k_grad = jax.random.split(key)
            envs, rows, nxt, new = [], [], [], []
            for kg in jax.random.split(k_grad, G):
                k_sample, k_update = jax.random.split(kg)
                k_row, k_env = jax.random.split(k_sample)
                rows.append(np.asarray(jax.random.randint(k_row, (B,), 0, max(filled, 1), dtype=jnp.int32)))
                envs.append(np.asarray(jax.random.randint(k_env, (B,), 0, N, dtype=jnp.int32)))
                k_next, k_new = jax.random.split(k_update)
                nxt.append(np.asarray(jax.random.normal(k_next, (B, A))))
                new.append(np.asarray(jax.random.normal(k_new, (B, A))))
            for k, v in (("envs", envs), ("rows", rows), ("next", nxt), ("new", new)):
                out[k].append(np.stack(v))
    return {k: np.stack(v) for k, v in out.items() if v}


def inject(member, draws) -> None:
    with torch.no_grad():
        for k, v in draws.items():
            member.inputs[k][: len(v)].copy_(torch.from_numpy(np.array(v)).to(member.inputs[k].dtype))


def build_pair(seed: int = 0):
    from sheeprl_tpu.algos.sac.agent import build_agent as jax_build_agent
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu.data.device_buffer import DeviceTransitionRing as JaxRing
    from sheeprl_tpu.engine.anakin import init_episode_stats, make_sac_anakin_dispatch
    from sheeprl_tpu.envs.jax import make_jax_env
    from sheeprl_tpu.parallel.mesh import MeshContext, build_mesh
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.engine.anakin import SACAnakin, sac_ring
    from sheeprl_tpu_torch.envs.batched import make_batched_env
    from sheeprl_tpu_torch.parallel.context import RunContext
    from tests.test_torch_ppo_modules import perturbed

    jcfg, tcfg = jax_compose(overrides=ARGS), compose(overrides=[*ARGS, "device=cpu"])
    jenv, tenv = make_jax_env("pendulum"), make_batched_env("pendulum")
    jp, tp = jenv.default_params(), tenv.default_params()
    ctx = MeshContext(mesh=build_mesh(devices=jax.devices()[:1]), precision="fp32", seed=seed)
    act_space = jenv.action_space(jp)
    actor, critic, params = jax_build_agent(ctx, act_space, gym.spaces.Dict({"state": jenv.observation_space(jp)}), jcfg)
    params = jax.tree.map(jnp.asarray, perturbed(params, 100 + seed))
    specs = {k: ((d,), jnp.float32) for k, d in (("obs", 3), ("next_obs", 3), ("actions", A), ("rewards", 1), ("dones", 1))}
    jring = JaxRing(CAP, N, specs)
    aopt, copt, topt, builder = make_sac_anakin_dispatch(jenv, jp, actor, critic, jcfg, act_space, jring, B)
    reset_keys = jax.random.split(jax.random.PRNGKey(11 + seed), N)
    env_state, obs0 = jax.vmap(jenv.reset, in_axes=(None, 0))(jp, reset_keys)
    carry = {
        "params": params,
        "opt_state": {"actor": aopt.init(params["actor"]), "critic": copt.init(params["critic"]), "alpha": topt.init(params["log_alpha"])},
        "env_state": env_state, "obs": obs0, "ring": jring.arrays, "rows_added": jnp.zeros((), jnp.int32),
        "gstep": jnp.zeros((), jnp.int32), "key": jax.random.PRNGKey(5 + seed), "episode_stats": init_episode_stats(N),
    }
    tctx = RunContext(torch.device("cpu"), seed, torch.float32)
    ring = sac_ring(tcfg, tenv, tp, tctx.device)
    member = SACAnakin(tctx, tcfg, tenv, tp, "state", ring, injected=True, injected_steps=PREFILL,
                       reset_draws=torch.from_numpy(reset_values(jenv, jp, reset_keys)))
    member.agent.load_state_dict(params_from_jax({"agent": params}, {"agent": member.agent})["agent"])
    return dict(jenv=jenv, jp=jp, builder=builder, carry=carry, member=member, tcfg=tcfg, tctx=tctx, tenv=tenv, tp=tp)


@pytest.fixture(scope="module")
def sac_dispatches():
    torch.set_num_threads(2)
    pair = build_pair()
    member, carry, builder = pair["member"], pair["carry"], pair["builder"]
    prefill_draws = reference_draws(pair["jenv"], pair["jp"], carry["key"], PREFILL, False, 0)
    after_prefill, pmet = jax.jit(builder(PREFILL, 0, False))(carry)
    train_draws = reference_draws(pair["jenv"], pair["jp"], after_prefill["key"], STEPS, True, PREFILL)
    after_prefill_host = jax.device_get(after_prefill)
    final, tmet = jax.device_get(jax.jit(builder(STEPS, G, True))(after_prefill))
    inject(member, prefill_draws)
    met_p = member.dispatch(PREFILL, 0, False)
    ring_after_prefill = {k: v.clone() for k, v in member.arrays.items()}
    inject(member, train_draws)
    met_t = member.dispatch(STEPS, G, True)
    return dict(pair, prefill=after_prefill_host, final=final, pmet=pmet, tmet=tmet, met_p=met_p, met_t=met_t,
                ring_after_prefill=ring_after_prefill, train_draws=train_draws)


def assert_ring_matches(arrays, jarrays):
    for k, v in arrays.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jarrays[k]), atol=RING_ATOL, rtol=0, err_msg=k)


def test_prefill_dispatch_matches_jax(sac_dispatches):
    assert_ring_matches(sac_dispatches["ring_after_prefill"], sac_dispatches["prefill"]["ring"])
    for k in ("Episodes/return_sum", "Episodes/len_sum", "Episodes/count"):
        np.testing.assert_allclose(float(sac_dispatches["met_p"][k]), float(sac_dispatches["pmet"][k]), rtol=1e-5, err_msg=k)


def test_training_dispatch_ring_and_counters_match_jax(sac_dispatches):
    member, final = sac_dispatches["member"], sac_dispatches["final"]
    assert_ring_matches(member.arrays, final["ring"])
    assert int(member.rows_added) == int(final["rows_added"]) == PREFILL + STEPS > CAP  # the ring wrapped
    assert int(member.gstep) == int(final["gstep"]) == STEPS * G
    np.testing.assert_allclose(member.obs.numpy(), np.asarray(final["obs"]), atol=RING_ATOL)
    for f in member.state._fields:
        np.testing.assert_allclose(getattr(member.state, f).numpy(), np.asarray(getattr(final["env_state"], f)), atol=RING_ATOL, err_msg=f)


def test_training_dispatch_update_matches_jax(sac_dispatches):
    member, final = sac_dispatches["member"], sac_dispatches["final"]
    agent = member.agent
    assert_params_match(agent, final["params"])
    modules = {"actor": agent.actor, "critic": agent.critic, "alpha": None}
    assert_opt_states_match(member.opt_states, final["opt_state"], modules, {n: STEPS * G for n in modules})
    for k in ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss"):
        np.testing.assert_allclose(float(sac_dispatches["met_t"][k]), float(sac_dispatches["tmet"][k]), rtol=F32["metric_rtol"], atol=1e-7, err_msg=k)


def test_ring_counters_round_trip(sac_dispatches, tmp_path):
    """The carry with its ring restores exactly; without it (``buffer.checkpoint=False``)
    replay restarts from an empty ring and ``rows_added`` from 0, the rest restored."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.engine.anakin import SACAnakin, sac_ring
    from sheeprl_tpu_torch.parallel.context import RunContext

    member, cfg = sac_dispatches["member"], sac_dispatches["tcfg"]
    for with_ring in (True, False):
        path = CheckpointManager(tmp_path / str(with_ring)).save(20, {"carry": member.carry(with_ring), "iter_num": 10, "policy_step": 20})
        state = CheckpointManager.load(path)
        other = SACAnakin(RunContext(torch.device("cpu"), 9, torch.float32), cfg, member.env, member.env_params, "state",
                          sac_ring(cfg, member.env, member.env_params, torch.device("cpu")))
        with torch.no_grad():
            for a in other.arrays.values():
                a.fill_(3.0)
        other.load_carry(state["carry"])
        assert ("ring" in state["carry"]) == with_ring and int(other.gstep) == STEPS * G
        for a, b in zip(member.agent.state_dict().values(), other.agent.state_dict().values()):
            assert torch.equal(a, b)
        if with_ring:
            assert int(other.rows_added) == PREFILL + STEPS
            for k, v in member.arrays.items():
                assert torch.equal(v, other.arrays[k]), k
        else:
            assert int(other.rows_added) == 0 and all(not a.any() for a in other.arrays.values())
        assert torch.equal(other.obs, member.obs)


@pytest.mark.parametrize(
    "extra,error,match",
    [
        (["algo.replay_ratio=0.5"], ValueError, r"integer algo\.replay_ratio"),
        (["env=jax_cartpole"], ValueError, r"continuous \(Box\) jax env"),
        (["env=continuous_dummy"], ValueError, r"algo\.anakin=True needs an on-device JAX environment"),
    ],
)
def test_entry_errors(tmp_path, monkeypatch, extra, error, match):
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    with pytest.raises(error, match=match):
        run([*ARGS, *extra, "device=cpu", "dry_run=True", "algo.run_test=False", f"log_root={tmp_path}"])
