"""Recurrent PPO of the PyTorch port against the JAX package, for both sequence models
(``lstm``: Flax's ``OptimizedLSTMCell``; ``attention``: causal windowed attention with
a rolling acting window).

Both packages build a tiny agent over image and vector keys, the JAX parameters
(perturbed with seeded noise) are carried into the port, and both are fed the same numpy
inputs: the env step (``step``) over a few steps with episode starts, carrying the
state; the sequence forward over ``[T, B]`` from an initial state with resets inside;
and one whole update (2 epochs x 2 env minibatches, clipped value loss, normalized
advantages) through ``make_ppo_recurrent_train_fn``, the port handed the env
permutations ``jax.random.permutation`` makes from the split keys.

Tolerances, float32: forward outputs atol = rtol = 1e-5; after the update, parameters
atol 1e-6 (moved by ~1e-3), Adam moments as ``test_torch_ppo_train.assert_moments`` holds them, losses
rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ppo_modules import TOL, jax_ctx, obs_batch, perturbed, spaces_pair, t
from tests.test_torch_ppo_train import F32, assert_moments, port_tree

T, N = 6, 4
CNN_SHAPE, VEC = (3, 36, 36), 5


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def build_pair(model: str, action: str = "discrete"):
    from sheeprl_tpu.algos.ppo_recurrent.agent import build_agent as jax_build_agent
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.parallel.context import RunContext

    env = {"discrete": "discrete_dummy", "continuous": "continuous_dummy"}[action]
    overrides = [
        "exp=ppo_recurrent", f"env={env}", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]", "algo.dense_units=12",
        "algo.encoder.cnn_features_dim=16", "algo.encoder.mlp_features_dim=10", "algo.rnn.lstm.hidden_size=8",
        f"algo.sequence_model={model}", "algo.attention.num_heads=2", "algo.attention.window=3", "algo.rnn.pre_rnn_mlp.apply=True",
        "algo.rnn.post_rnn_mlp.apply=True", f"algo.rollout_steps={T}", f"env.num_envs={N}", "algo.per_rank_num_batches=2",
        "algo.update_epochs=2", "algo.normalize_advantages=True", "algo.clip_vloss=True", "algo.max_grad_norm=0.5",
        "algo.ent_coef=0.01", "mesh.precision=32-true",
    ]
    jcfg, tcfg = jax_compose(overrides=overrides), compose(overrides=[*overrides, "device=cpu"])
    obs_j, obs_t, act_j, act_t = spaces_pair(action, CNN_SHAPE, VEC)
    jagent, params = jax_build_agent(jax_ctx(), act_j, obs_j, jcfg)
    params = perturbed(params, 11)
    agent = build_agent(RunContext(torch.device("cpu"), 0), act_t, obs_t, tcfg)
    agent.load_state_dict(params_from_jax({"agent": params}, {"agent": agent})["agent"])
    return jagent, params, agent, jcfg, tcfg, obs_j


def zero_states(jcfg, tcfg, n):
    from sheeprl_tpu.algos.ppo_recurrent.agent import make_zero_state as jax_zero
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import make_zero_state

    return jax_zero(jcfg)(n), make_zero_state(tcfg, torch.device("cpu"))(n)


def sequence_inputs(rng, obs_space, act_sum: int):
    obs = obs_batch(rng, obs_space, (T, N))
    prev = np.eye(act_sum, dtype=np.float32)[rng.integers(0, act_sum, (T, N))]
    is_first = (rng.random((T, N, 1)) < 0.25).astype(np.float32)
    is_first[0] = 1.0
    return obs, prev, is_first


@pytest.mark.parametrize("model", ["lstm", "attention"])
def test_recurrent_agent_step_and_sequence_match_jax(model):
    from sheeprl_tpu.algos.ppo_recurrent.agent import RecurrentPPOAgent

    jagent, params, agent, jcfg, tcfg, obs_space = build_pair(model)
    rng = np.random.default_rng(12)
    obs, prev, is_first = sequence_inputs(rng, obs_space, 3)
    jstate, state = zero_states(jcfg, tcfg, N)
    jstep = jax.jit(lambda p, o, a, f, s: jagent.apply(p, o, a, f, s, method=RecurrentPPOAgent.step))
    for i in range(T):
        o = {k: v[i] for k, v in obs.items()}
        jout, jval, jstate = jstep(params, o, prev[i], is_first[i], jstate)
        with torch.no_grad():
            out, val, state = agent.step({k: t(v) for k, v in o.items()}, t(prev[i]), t(is_first[i]), state)
        np.testing.assert_allclose(out[0].numpy(), np.asarray(jout[0]), **TOL)
        np.testing.assert_allclose(val.numpy(), np.asarray(jval), **TOL)
        for a, b in zip(state, jstate):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    init_j = tuple(jnp.asarray(rng.normal(0, 1, np.shape(s)).astype(np.float32)) for s in jstate)
    jout, jval = jax.jit(jagent.apply)(params, obs, prev, is_first, init_j)
    with torch.no_grad():
        out, val = agent({k: t(v) for k, v in obs.items()}, t(prev), t(is_first), tuple(t(s) for s in init_j))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout[0]), **TOL)
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), **TOL)


@pytest.mark.parametrize("model,action", [("lstm", "discrete"), ("attention", "continuous")])
def test_recurrent_update_matches_jax(model, action):
    from sheeprl_tpu.algos.ppo_recurrent.ppo_recurrent import make_ppo_recurrent_train_fn
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import RecurrentPPOTrainFns
    from sheeprl_tpu_torch.parallel.context import RunContext

    jagent, params, agent, jcfg, tcfg, obs_space = build_pair(model, action)
    rng = np.random.default_rng(13)
    act_sum = 3 if action == "discrete" else 2
    obs, prev, is_first = sequence_inputs(rng, obs_space, act_sum)
    seq = {**obs, "prev_actions": prev if action == "discrete" else rng.uniform(-1, 1, (T, N, 2)).astype(np.float32), "is_first": is_first}
    seq["actions"] = (rng.integers(0, 3, (T, N, 1)).astype(np.float32) if action == "discrete" else rng.uniform(-1, 1, (T, N, 2)).astype(np.float32))
    # the acting policy's log-probs and values (a little noise: a policy a few steps older)
    from sheeprl_tpu.algos.ppo.utils import log_prob_and_entropy as jax_lpe

    jstate, _ = zero_states(jcfg, tcfg, N)
    c0 = rng.normal(0, 0.5, np.shape(jstate[0])).astype(np.float32) if model == "lstm" else np.zeros(np.shape(jstate[0]), np.float32)
    h0 = rng.normal(0, 0.5, np.shape(jstate[1])).astype(np.float32) if model == "lstm" else np.zeros(np.shape(jstate[1]), np.float32)
    jout, jval = jax.jit(jagent.apply)(params, obs, seq["prev_actions"], is_first, (c0, h0))
    lp, _ = jax_lpe(jout, seq["actions"], action == "continuous")
    seq["logprobs"] = (np.asarray(lp) + rng.normal(0, 0.02, (T, N))).astype(np.float32)
    seq["values"] = (np.asarray(jval)[..., 0] + rng.normal(0, 0.05, (T, N))).astype(np.float32)
    seq["returns"], seq["advantages"] = (rng.normal(0, 1, (T, N)).astype(np.float32) for _ in range(2))

    opt, train_fn = make_ppo_recurrent_train_fn(jax_ctx(), jagent, jcfg, ["rgb", "state"])
    key = jax.random.PRNGKey(14)
    p, o_state, m = train_fn(params, opt.init(params), seq, c0, h0, key, 0.2, 0.01)
    perms = np.stack([np.asarray(jax.random.permutation(k, N)) for k in jax.random.split(key, 2)])
    fns = RecurrentPPOTrainFns(RunContext(torch.device("cpu"), 0), agent, tcfg, ["rgb", "state"])
    got = fns.train_fn({k: t(v) for k, v in seq.items()}, t(c0), t(h0), t(perms), 0.2, 0.01)
    for k, v in got.items():
        np.testing.assert_allclose(v, float(m[k]), rtol=F32["metric_rtol"], atol=1e-7, err_msg=k)
    want = port_tree(p, agent)
    for k, v in agent.state_dict().items():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(), atol=F32["params"], rtol=0, err_msg=k)
    assert_moments(fns.opt_state, o_state, agent)
