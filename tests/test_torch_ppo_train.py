"""Whole PPO and A2C updates of the PyTorch port against the JAX package.

Both packages build a tiny agent over image and vector keys (a Nature-CNN trunk with its
8/4/3 kernels on 36 x 36 frames), the JAX parameters (perturbed with seeded noise) are
carried into the port, and both run their update on the same numpy rollout:

* PPO: two updates through ``PPOTrainFns.train_fn`` (2 epochs x 2 minibatches each), at
  ``exp=ppo_atari``'s options: annealed learning rate (the port's schedule runs on the
  device from the Adam count), annealed clip and entropy coefficients (other values for
  the second update), normalized advantages, clipped value loss, global-norm clipping.
  The port is handed the permutations ``jax.random.permutation`` makes from the split
  keys of each update's key;
* A2C: two full-batch steps of ``make_a2c_train_fn`` (``rmsprop_tf``, ``loss_reduction:
  sum``, normalized advantages), continuous actor.

The rollout's log-probs and values are the acting policy's (``acted``), so the ratios
start near 1, as in a real update. Compared afterwards: the parameters, the optimizer's
moments and the losses. Tolerances, float32 (``F32``): parameters atol 1e-6 (the
updates move them by ~1e-3), moments atol 1e-3 of their leaf's largest entry (``assert_moments``), losses
rtol 1e-4. The bf16-mixed PPO update is held to JAX's bf16 update as
``test_torch_dv3_bf16.py`` holds DreamerV3's: ``test_torch_ppo_bf16.py``.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_ppo_modules import jax_ctx, obs_batch, perturbed, spaces_pair, t

F32 = dict(params=1e-6, mom_rtol=1e-3, metric_rtol=1e-4)
ATARI_OPTS = [
    "algo.rollout_steps=8", "env.num_envs=2", "algo.per_rank_batch_size=8", "algo.update_epochs=2",
    "algo.anneal_lr=True", "algo.normalize_advantages=True", "algo.clip_coef=0.1", "algo.anneal_clip_coef=True",
    "algo.clip_vloss=True", "algo.ent_coef=0.01", "algo.anneal_ent_coef=True", "algo.vf_coef=0.5",
    "algo.max_grad_norm=0.5", "algo.optimizer.lr=2.5e-4", "algo.optimizer.eps=1e-6", "algo.dense_act=relu",
]
CNN_SHAPE, VEC = (3, 36, 36), 6
NUM_UPDATES = 3


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def rollout_data(action: str, n: int, obs_space, seed: int, flat: bool = True):
    rng = np.random.default_rng(seed)
    data = obs_batch(rng, obs_space, (n,))
    if action == "continuous":
        data["actions"] = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    else:
        dims = [3] if action == "discrete" else [2, 3]
        data["actions"] = np.stack([rng.integers(0, d, n) for d in dims], -1).astype(np.float32)
    for k in ("logprobs", "values", "returns", "advantages"):
        data[k] = rng.normal(-1.0 if k == "logprobs" else 0.0, 1.0, n).astype(np.float32)
    return data


def acted(jagent, params, data, seed: int):
    """The rollout's log-probs and values as the policy that acted would have stored
    them: the JAX agent's at ``params``, plus a little noise (a policy a few steps
    older). Random ones would put most ratios outside the clip, where which entries
    pass it, and so the gradient, hinges on the last bits of the log-probs."""
    from sheeprl_tpu.algos.ppo.utils import log_prob_and_entropy as jax_lpe

    rng = np.random.default_rng(seed)
    obs = {k: data[k] for k in ("rgb", "state")}
    actor_out, values = jax.jit(jagent.apply)(params, obs)
    lp, _ = jax_lpe(actor_out, data["actions"], jagent.is_continuous)
    data["logprobs"] = (np.asarray(lp) + rng.normal(0, 0.02, lp.shape)).astype(np.float32)
    data["values"] = (np.asarray(values)[..., 0] + rng.normal(0, 0.05, lp.shape)).astype(np.float32)
    return data


def build_ppo(action: str, precision: str, extra=()):
    from sheeprl_tpu.algos.ppo.ppo import PPOTrainFns as JaxFns
    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainFns
    from sheeprl_tpu_torch.parallel.context import RunContext, compute_dtype
    from tests.test_torch_ppo_modules import agent_pair

    jagent, params, agent, jcfg, tcfg, obs_space = agent_pair(action, precision, [*ATARI_OPTS, *extra], CNN_SHAPE, VEC)
    keys = ["rgb", "state"]
    jfns = JaxFns(jax_ctx(precision), jagent, jcfg, keys, NUM_UPDATES)
    fns = PPOTrainFns(RunContext(torch.device("cpu"), 0, compute_dtype(precision)), agent, tcfg, keys, NUM_UPDATES)
    return jfns, jagent, params, fns, agent, obs_space


def run_ppo_pair(action: str, precision: str, updates: int = 2, extra=(), seed: int = 0):
    """``updates`` updates in each package from the same parameters and rollouts."""
    jfns, jagent, params, fns, agent, obs_space = build_ppo(action, precision, extra)
    before = {k: v.detach().clone() for k, v in agent.state_dict().items()}
    o_state = jfns.opt.init(params)
    p = params
    jmet, met = [], []
    for update, (clip, ent) in enumerate(((0.1, 0.01), (0.0667, 0.00667))[:updates], start=1):
        data = acted(jagent, params, rollout_data(action, jfns.batch_n, obs_space, 20 + update + 10 * seed), 50 + update + 10 * seed)
        key = jax.random.PRNGKey(30 + update)
        epochs = fns.cfg.algo.update_epochs
        perms = np.stack([np.asarray(jax.random.permutation(k, jfns.batch_n)) for k in jax.random.split(key, epochs)])
        p, o_state, m = jfns.train_fn(p, o_state, data, key, clip, ent)
        jmet.append(jax.device_get(m))
        met.append(fns.train_fn({k: t(v) for k, v in data.items()}, t(perms), clip, ent))
    return params, p, o_state, before, fns, agent, jmet, met


def adam(o_state):
    from tests.test_torch_dv3_train import _adam_state

    return _adam_state(o_state)


def port_tree(tree, agent):
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax

    return params_from_jax({"agent": jax.device_get(tree)}, {"agent": agent})["agent"]


def moments(tree, agent):
    from sheeprl_tpu_torch.algos.dreamer_v3.params import parameter_list_from_jax

    return parameter_list_from_jax(jax.device_get(tree), agent)


def assert_moments(opt_state, o_state, agent):
    """Each Adam moment within ``mom_rtol`` of its leaf's largest entry, plus 1e-6 of the
    largest over all leaves: a leaf whose gradient vanishes analytically (the attention's
    key bias, which the softmax cancels) holds only rounding noise."""
    state = adam(o_state)
    for name in ("mu", "nu"):
        refs = moments(getattr(state, name), agent)
        floor = 1e-6 * max(float(r.abs().max()) for r in refs)
        for got, ref, (leaf, _) in zip(opt_state[name], refs, agent.named_parameters()):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=F32["mom_rtol"] * float(ref.abs().max()) + floor, rtol=0, err_msg=f"{name} {leaf}")


@pytest.mark.parametrize("action", ["discrete", "continuous"])
def test_ppo_update_f32_matches_jax(action):
    params, new_params, o_state, _, fns, agent, jmet, met = run_ppo_pair(action, "32-true")
    want = port_tree(new_params, agent)
    for k, v in agent.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=F32["params"], rtol=0, err_msg=k)
    assert int(fns.opt_state["count"]) == 8 == int(np.asarray(adam(o_state).count))
    assert_moments(fns.opt_state, o_state, agent)
    for jm, m in zip(jmet, met):
        for k, v in m.items():
            np.testing.assert_allclose(v, float(jm[k]), rtol=F32["metric_rtol"], atol=1e-7, err_msg=k)
    # the annealed lr after 8 of the 12 scheduled steps, as optax's schedule gives it
    np.testing.assert_allclose(fns.lr_at(8), 2.5e-4 * (1 - 8 / 12) + 1e-8 * 8 / 12, rtol=1e-6)


def test_a2c_steps_match_jax():
    from sheeprl_tpu.algos.a2c.a2c import make_a2c_train_fn
    from sheeprl_tpu.algos.ppo.agent import build_agent as jax_build_agent
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.algos.a2c.a2c import A2CTrainFns
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.parallel.context import RunContext

    overrides = [
        "exp=a2c", "env=continuous_dummy", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]", "algo.dense_units=12",
        "algo.encoder.cnn_features_dim=16", "algo.encoder.mlp_features_dim=10", "algo.rollout_steps=8", "env.num_envs=2",
        "algo.normalize_advantages=True", "algo.max_grad_norm=0.5", "algo.ent_coef=0.01", "mesh.precision=32-true",
    ]
    jcfg, tcfg = jax_compose(overrides=overrides), compose(overrides=[*overrides, "device=cpu"])
    obs_j, obs_t, act_j, act_t = spaces_pair("continuous", CNN_SHAPE, VEC)
    jagent, params = jax_build_agent(jax_ctx(), act_j, obs_j, jcfg)
    params = perturbed(params, 9)
    agent = build_agent(RunContext(torch.device("cpu"), 0), act_t, obs_t, tcfg)
    agent.load_state_dict(params_from_jax({"agent": params}, {"agent": agent})["agent"])
    opt, train_fn = make_a2c_train_fn(jax_ctx(), jagent, jcfg, ["rgb", "state"])
    fns = A2CTrainFns(RunContext(torch.device("cpu"), 0), agent, tcfg, ["rgb", "state"])
    p, o_state = params, opt.init(params)
    for i in range(2):
        data = rollout_data("continuous", 16, obs_j, 40 + i)
        data.pop("logprobs")
        p, o_state, m = train_fn(p, o_state, data)
        got = fns.train_fn({k: t(v) for k, v in data.items()})
        for k, v in got.items():
            np.testing.assert_allclose(v, float(m[k]), rtol=F32["metric_rtol"], err_msg=k)
    want = port_tree(p, agent)
    for k, v in agent.state_dict().items():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(), atol=F32["params"], rtol=0, err_msg=k)
    assert int(fns.opt_state["count"]) == 2
