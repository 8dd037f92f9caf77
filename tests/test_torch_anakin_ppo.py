"""The PyTorch port's Anakin PPO iteration (``engine/anakin.py::PPOAnakin``) against the
JAX package's ``make_ppo_anakin_iteration``.

Both packages build the reference test's tiny agent (``tests/test_algos/test_anakin.py``:
batched CartPole, 2 envs x 8 steps, minibatches of 8, two epochs, MLPs of width 8), the
JAX parameters (perturbed with seeded noise) carried into the port, and run one
iteration from the same env reset. The port is handed the draws the reference's key
chain makes (``reference_draws``): per step ``split(key, 3)``, the action's Gumbel noise
from ``k_act`` and each env's reset draws from ``split(k_step, N)`` and
``step_autoreset``'s own ``split``; then the epochs' permutations from ``k_train``.

Compared: the collected batch (observations, actions, log-probs, values, returns and
advantages within atol 1e-5), the env state and episode sums after it, and the update's
parameters, Adam moments and losses at ``tests/test_torch_ppo_train.py``'s ``F32``
limits. The port's Anakin update equals its host loop's ``PPOTrainFns.train_fn`` on the
same batch and permutations bit for bit, and the carry round-trips through
``CheckpointManager``.
"""

import copy

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from tests.test_torch_ppo_train import F32, assert_moments, port_tree

ARGS = [
    "exp=ppo", "env=jax_cartpole", "algo.anakin=True", "algo.mlp_keys.encoder=[state]", "algo.rollout_steps=8",
    "algo.per_rank_batch_size=8", "algo.update_epochs=2", "algo.dense_units=8", "algo.mlp_layers=1",
    "algo.encoder.mlp_features_dim=8", "env.num_envs=2", "env.capture_video=False", "buffer.memmap=False",
    "mesh.precision=32-true",
]
BATCH_ATOL = 1e-5
CLIP, ENT = 0.2, 0.01


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_ctx(seed: int = 0):
    from sheeprl_tpu.parallel.mesh import MeshContext, build_mesh

    return MeshContext(mesh=build_mesh(devices=jax.devices()[:1]), precision="fp32", seed=seed)


def reset_values(jenv, jp, keys):
    """The port's reset draws for ``reset`` under each of ``keys``: the state's fields the
    reference draws uniformly."""
    states = jax.vmap(jenv.reset, in_axes=(None, 0))(jp, keys)[0]
    fields = ["position"] if "position" in states._fields else [f for f in states._fields if f != "time"]
    return np.stack([np.asarray(getattr(states, f)) for f in fields], -1)


def reference_draws(jenv, jp, key, steps: int, num_envs: int, heads, epochs: int, batch_n: int):
    """The draws of one reference iteration from its carried ``key``: per step the Gumbel
    noise of each discrete head (``heads``: their sizes) and the envs' reset draws; then
    the epochs' permutations."""
    acts, resets = [], []
    for _ in range(steps):
        key, k_act, k_step = jax.random.split(key, 3)
        acts.append([np.asarray(jax.random.gumbel(k, (num_envs, d))) for k, d in zip(jax.random.split(k_act, len(heads)), heads)])
        step_keys = jax.random.split(k_step, num_envs)
        resets.append(reset_values(jenv, jp, jax.vmap(lambda k: jax.random.split(k)[1])(step_keys)))
    key, k_train = jax.random.split(key)
    perms = np.stack([np.asarray(jax.random.permutation(k, batch_n)) for k in jax.random.split(k_train, epochs)])
    return acts, np.stack(resets), perms


def build_pair(seed: int = 0):
    """The JAX iteration's inputs and a port member over the same parameters and reset."""
    from sheeprl_tpu.algos.ppo.agent import build_agent as jax_build_agent
    from sheeprl_tpu.algos.ppo.ppo import PPOTrainFns as JaxFns
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu.engine.anakin import init_episode_stats as jax_stats
    from sheeprl_tpu.envs.jax import make_jax_env
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.engine.anakin import PPOAnakin
    from sheeprl_tpu_torch.envs.batched import make_batched_env
    from sheeprl_tpu_torch.parallel.context import RunContext
    from tests.test_torch_ppo_modules import perturbed

    jcfg, tcfg = jax_compose(overrides=ARGS), compose(overrides=[*ARGS, "device=cpu"])
    jenv, tenv = make_jax_env("cartpole"), make_batched_env("cartpole")
    jp, tp = jenv.default_params(), tenv.default_params()
    ctx = jax_ctx(seed)
    obs_space = gym.spaces.Dict({"state": jenv.observation_space(jp)})
    jagent, params = jax_build_agent(ctx, jenv.action_space(jp), obs_space, jcfg)
    params = perturbed(params, seed + 7)
    jfns = JaxFns(ctx, jagent, jcfg, ["state"], 4)
    reset_keys = jax.random.split(jax.random.PRNGKey(7 + seed), 2)
    env_state, obs0 = jax.vmap(jenv.reset, in_axes=(None, 0))(jp, reset_keys)
    carry = {"params": params, "opt_state": jfns.opt.init(params), "env_state": env_state, "obs": obs0,
             "key": jax.random.PRNGKey(3 + seed), "episode_stats": jax_stats(2)}
    tctx = RunContext(torch.device("cpu"), seed, torch.float32)
    member = PPOAnakin(tctx, tcfg, tenv, tp, "state", 4, injected=True, reset_draws=torch.from_numpy(reset_values(jenv, jp, reset_keys)))
    member.agent.load_state_dict(params_from_jax({"agent": params}, {"agent": member.agent})["agent"])
    return dict(jenv=jenv, jp=jp, jagent=jagent, jfns=jfns, jcfg=jcfg, carry=carry, member=member, tcfg=tcfg, tctx=tctx)


def inject(member, acts, resets) -> None:
    with torch.no_grad():
        for t, heads in enumerate(acts):
            for buf, d in zip(member.inputs["actions"], heads):
                buf[t].copy_(torch.from_numpy(np.array(d)))
        member.inputs["reset"].copy_(torch.from_numpy(resets))


@pytest.fixture(scope="module")
def ppo_iteration():
    from sheeprl_tpu.engine.anakin import make_ppo_anakin_iteration

    torch.set_num_threads(2)
    pair = build_pair()
    member, jfns, carry = pair["member"], pair["jfns"], pair["carry"]
    iteration = make_ppo_anakin_iteration(pair["jenv"], pair["jp"], pair["jagent"], jfns, pair["jcfg"], "state", return_batch=True)
    new_carry, jmet, jdata, _ = jax.device_get(jax.jit(iteration)(carry, CLIP, ENT))
    acts, resets, perms = reference_draws(pair["jenv"], pair["jp"], carry["key"], 8, 2, [2], 2, jfns.batch_n)
    inject(member, acts, resets)
    before = {k: v.clone() for k, v in member.agent.state_dict().items()}
    coefs = torch.tensor([CLIP, ENT], dtype=torch.float32)
    met = member.iterate(coefs, torch.from_numpy(perms))
    batch = {k: v.clone() for k, v in member.last_batch.items()}
    return dict(pair, new_carry=new_carry, jmet=jmet, jdata=jdata, met=met, batch=batch, before=before, perms=perms, acts=acts, resets=resets)


def test_collected_batch_matches_jax(ppo_iteration):
    batch, jdata = ppo_iteration["batch"], ppo_iteration["jdata"]
    assert set(batch) == set(jdata)
    for k, v in batch.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jdata[k]), atol=BATCH_ATOL, rtol=0, err_msg=k)
    assert np.asarray(jdata["actions"]).min() == 0 and np.asarray(jdata["actions"]).max() == 1


def test_env_state_and_episode_sums_match_jax(ppo_iteration):
    member, new_carry, jmet = ppo_iteration["member"], ppo_iteration["new_carry"], ppo_iteration["jmet"]
    np.testing.assert_allclose(member.obs.numpy(), np.asarray(new_carry["obs"]), atol=BATCH_ATOL)
    for f in member.state._fields:
        np.testing.assert_allclose(getattr(member.state, f).numpy(), np.asarray(getattr(new_carry["env_state"], f)), atol=BATCH_ATOL, err_msg=f)
    for k, v in member.stats.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(new_carry["episode_stats"][k]), atol=BATCH_ATOL, err_msg=k)
    for k in ("Episodes/return_sum", "Episodes/len_sum", "Episodes/count"):
        np.testing.assert_allclose(float(ppo_iteration["met"][k]), float(jmet[k]), rtol=1e-6, err_msg=k)
    assert float(jmet["Episodes/count"]) == 0.0 or float(jmet["Episodes/len_sum"]) > 0


def test_update_matches_jax(ppo_iteration):
    member, new_carry, jmet = ppo_iteration["member"], ppo_iteration["new_carry"], ppo_iteration["jmet"]
    agent = member.agent
    want = port_tree(new_carry["params"], agent)
    for k, v in agent.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=F32["params"], rtol=0, err_msg=k)
        assert not torch.equal(v, ppo_iteration["before"][k]), k
    assert int(member.fns.opt_state["count"]) == member.fns.grad_steps_per_update == 4
    assert_moments(member.fns.opt_state, new_carry["opt_state"], agent)
    for k in ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss"):
        np.testing.assert_allclose(float(ppo_iteration["met"][k]), float(jmet[k]), rtol=F32["metric_rtol"], atol=1e-7, err_msg=k)


def test_anakin_update_equals_host_update_bit_for_bit(ppo_iteration):
    """The same batch and permutations through the host loop's ``train_fn`` on a copy of
    the starting agent: every parameter and moment equal bit for bit."""
    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainFns

    member = ppo_iteration["member"]
    twin = copy.deepcopy(member.agent)
    twin.load_state_dict(ppo_iteration["before"])
    fns = PPOTrainFns(ppo_iteration["tctx"], twin, ppo_iteration["tcfg"], ["state"], 4)
    losses = fns.train_fn(ppo_iteration["batch"], torch.from_numpy(ppo_iteration["perms"]), CLIP, ENT)
    for (k, v), w in zip(member.agent.state_dict().items(), twin.state_dict().values()):
        assert torch.equal(v, w), k
    for name in ("mu", "nu"):
        for a, b in zip(member.fns.opt_state[name], fns.opt_state[name]):
            assert torch.equal(a, b), name
    for k, v in losses.items():
        assert v == float(ppo_iteration["met"][k]), k


def test_carry_round_trips_through_checkpoint_manager(ppo_iteration, tmp_path):
    """Save the member's carry, load it into a member built from another seed: every
    tensor equal, and both take the same next iteration bit for bit."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.engine.anakin import PPOAnakin

    member = ppo_iteration["member"]
    path = CheckpointManager(tmp_path).save(16, {"carry": member.carry(), "update": 1, "policy_step": 16, "last_log": 16, "last_checkpoint": 16})
    state = CheckpointManager.load(path)
    other = PPOAnakin(ppo_iteration["tctx"].__class__(torch.device("cpu"), 5, torch.float32), ppo_iteration["tcfg"], member.env, member.env_params,
                      "state", 4, injected=True)
    other.load_carry(state["carry"])
    assert state["update"] == 1 and set(state["carry"]) == {"params", "opt_state", "env_state", "obs", "generators", "episode_stats"}
    for a, b in zip(member.carry()["params"].values(), other.carry()["params"].values()):
        assert torch.equal(a, b)
    for m in (member, other):
        inject(m, ppo_iteration["acts"], ppo_iteration["resets"])
    coefs = torch.tensor([CLIP, ENT], dtype=torch.float32)
    perms = torch.from_numpy(ppo_iteration["perms"])
    out_a, out_b = member.iterate(coefs, perms), other.iterate(coefs, perms)
    for k in out_a:
        assert torch.equal(out_a[k], out_b[k]), k
    for a, b in zip(member.agent.state_dict().values(), other.agent.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(member.obs, other.obs) and int(member.fns.opt_state["count"]) == 8
