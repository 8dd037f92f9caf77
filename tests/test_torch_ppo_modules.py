"""The PPO family's modules in the PyTorch port against the JAX package.

Every input comes from numpy with a seed and goes through both packages; parameters are
the JAX package's (perturbed with seeded noise, so that no bias is zero), carried into
the port with ``params_from_jax``. Draws are JAX's own (``jax.random.gumbel`` per head
from the split keys, ``jax.random.normal``), handed to the port.

Tolerances, float32: forward outputs atol = rtol = 1e-5 (convs and matmuls sum in
another order; the deepest module here chains 6 layers); losses, GAE and
normalisation rtol 1e-6 (elementwise math and one reduction); sampled actions equal.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.envs import spaces as tspaces

TOL = dict(atol=1e-5, rtol=1e-5)
EXACTISH = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def perturbed(params, seed: int, scale: float = 0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + rng.normal(0.0, scale, x.shape)).astype(np.float32), jax.device_get(params))


def carry(tree, module):
    from sheeprl_tpu_torch.algos.dreamer_v3.params import module_state_from_jax

    module.load_state_dict(module_state_from_jax(tree["params"] if "params" in tree else tree, module))
    return module


def t(x):
    return torch.from_numpy(np.array(x))


def spaces_pair(action: str, cnn_shape=None, vec: int = 0):
    """The same observation and action spaces in gymnasium (JAX) and in the port."""
    obs_j, obs_t = {}, {}
    if cnn_shape is not None:
        obs_j["rgb"] = gym.spaces.Box(0, 255, cnn_shape, np.uint8)
        obs_t["rgb"] = tspaces.Box(0, 255, cnn_shape, np.uint8)
    if vec:
        obs_j["state"] = gym.spaces.Box(-20, 20, (vec,), np.float32)
        obs_t["state"] = tspaces.Box(-20, 20, (vec,), np.float32)
    acts = {
        "discrete": (gym.spaces.Discrete(3), tspaces.Discrete(3)),
        "multidiscrete": (gym.spaces.MultiDiscrete([2, 3]), tspaces.MultiDiscrete([2, 3])),
        "continuous": (gym.spaces.Box(-1, 1, (2,), np.float32), tspaces.Box(-1, 1, (2,), np.float32)),
    }[action]
    return gym.spaces.Dict(obs_j), tspaces.Dict(obs_t), acts[0], acts[1]


def obs_batch(rng, obs_space, lead):
    out = {}
    for k, s in obs_space.spaces.items():
        if s.dtype == np.uint8:
            out[k] = rng.integers(0, 256, (*lead, *s.shape), dtype=np.uint8)
        else:
            out[k] = rng.normal(0, 2, (*lead, *s.shape)).astype(np.float32)
    return out


# --------------------------------------------------------------------------- encoder

ENCODER_CASES = {
    "cnn": ((3, 36, 36), 0),
    "mlp": (None, 6),
    "both": ((3, 36, 36), 6),
    "stacked": ((2, 3, 36, 36), 6),
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_multi_encoder_matches_jax(case):
    from sheeprl_tpu.models.blocks import MultiEncoder as JaxMultiEncoder
    from sheeprl_tpu_torch.models.blocks import MultiEncoder

    cnn_shape, vec = ENCODER_CASES[case]
    obs_space, _, _, _ = spaces_pair("discrete", cnn_shape, vec)
    cnn_keys = ["rgb"] if cnn_shape else []
    mlp_keys = ["state"] if vec else []
    kw = dict(cnn_channels=(4, 8, 8), cnn_features_dim=16, mlp_hidden_sizes=(12, 12), mlp_features_dim=10, activation="tanh")
    jenc = JaxMultiEncoder(cnn_keys=cnn_keys, mlp_keys=mlp_keys, cnn_stacked=case == "stacked", **kw)
    rng = np.random.default_rng(0)
    obs = obs_batch(rng, obs_space, (5,))
    params = perturbed(jax.jit(jenc.init)(jax.random.PRNGKey(0), obs), 1)
    want = np.asarray(jax.jit(jenc.apply)(params, obs))
    enc = MultiEncoder({k: cnn_shape for k in cnn_keys}, {k: vec for k in mlp_keys}, **kw)
    carry(params, enc)
    got = enc({k: t(v) for k, v in obs.items()}).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    # the lead axes fold into the batch: a [T, B] batch equals its flattened rows
    seq = obs_batch(rng, obs_space, (2, 3))
    got_seq = enc({k: t(v) for k, v in seq.items()}).detach().numpy()
    np.testing.assert_allclose(got_seq, np.asarray(jax.jit(jenc.apply)(params, seq)), **TOL)


def test_cnn_obs_to_nhwc_matches_jax():
    from sheeprl_tpu.models.blocks import cnn_obs_to_nhwc as jax_fn
    from sheeprl_tpu_torch.models.blocks import cnn_obs_to_nhwc

    x = np.random.default_rng(2).integers(0, 256, (2, 4, 3, 5, 6), dtype=np.uint8)
    for stacked in (False, True):
        np.testing.assert_array_equal(cnn_obs_to_nhwc(t(x), stacked).numpy(), np.asarray(jax_fn(jnp.asarray(x), stacked)))


# --------------------------------------------------------------------------- agent


def tiny_cfgs(action: str, extra=()):
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.config.core import compose as torch_compose

    env = {"discrete": "discrete_dummy", "multidiscrete": "multidiscrete_dummy", "continuous": "continuous_dummy"}[action]
    overrides = [
        "exp=ppo_dummy", f"env={env}", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]",
        "algo.dense_units=12", "algo.encoder.cnn_features_dim=16", "algo.encoder.mlp_features_dim=10", *extra,
    ]
    return jax_compose(overrides=overrides), torch_compose(overrides=[*overrides, "device=cpu"])


def jax_ctx(precision="fp32", seed=0):
    from sheeprl_tpu.parallel.mesh import MeshContext, build_mesh

    return MeshContext(mesh=build_mesh(devices=jax.devices()[:1]), precision=precision, seed=seed)


def agent_pair(action: str, precision: str = "32-true", extra=(), cnn_shape=(3, 36, 36), vec=6, seed=0):
    """The JAX PPO agent and the port's, holding the same perturbed parameters."""
    from sheeprl_tpu.algos.ppo.agent import build_agent as jax_build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.parallel.context import RunContext, compute_dtype

    jcfg, tcfg = tiny_cfgs(action, [f"mesh.precision={precision}", *extra])
    obs_j, obs_t, act_j, act_t = spaces_pair(action, cnn_shape, vec)
    jagent, params = jax_build_agent(jax_ctx(precision, seed), act_j, obs_j, jcfg)
    params = perturbed(params, seed + 7)
    agent = build_agent(RunContext(torch.device("cpu"), seed, compute_dtype(precision)), act_t, obs_t, tcfg)
    agent.load_state_dict(params_from_jax({"agent": params}, {"agent": agent})["agent"])
    return jagent, params, agent, jcfg, tcfg, obs_j


@pytest.mark.parametrize("action", ["discrete", "multidiscrete", "continuous"])
def test_ppo_agent_matches_jax(action):
    jagent, params, agent, _, _, obs_space = agent_pair(action)
    obs = obs_batch(np.random.default_rng(3), obs_space, (7,))
    jout, jval = jax.jit(jagent.apply)(params, obs)
    out, val = agent({k: t(v) for k, v in obs.items()})
    assert len(out) == len(jout)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval), **TOL)
    names = dict(agent.named_parameters())
    assert ("actor_head.weight" in names) == (action == "continuous")


# --------------------------------------------------------------------------- sampling


@pytest.mark.parametrize("action", ["discrete", "multidiscrete", "continuous"])
def test_sampling_with_injected_draws_matches_jax(action):
    from sheeprl_tpu.algos.ppo.utils import log_prob_and_entropy as jax_lpe
    from sheeprl_tpu.algos.ppo.utils import sample_actions as jax_sample
    from sheeprl_tpu_torch.algos.ppo.utils import draw_shapes, log_prob_and_entropy, sample_actions

    rng = np.random.default_rng(4)
    continuous = action == "continuous"
    dims = {"discrete": [3], "multidiscrete": [2, 3], "continuous": [4]}[action]
    actor_out = [rng.normal(0, 1.5, (64, d)).astype(np.float32) for d in dims]
    key = jax.random.PRNGKey(5)
    jact, _, jlp = jax_sample(key, [jnp.asarray(a) for a in actor_out], continuous)
    # the draws jax.random.categorical / Normal.sample make from the same key
    if continuous:
        draws = [np.asarray(jax.random.normal(key, (64, 2)))]
    else:
        draws = [np.asarray(jax.random.gumbel(k, (64, d))) for k, d in zip(jax.random.split(key, len(dims)), dims)]
    tout = [t(a) for a in actor_out]
    assert [tuple(d.shape) for d in draws] == draw_shapes(tout, continuous)
    act, stored, lp = sample_actions(tout, continuous, draws=[t(d) for d in draws])
    if continuous:
        np.testing.assert_allclose(act.numpy(), np.asarray(jact), **EXACTISH)
    else:
        np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), **EXACTISH)
    # greedy: the mode
    gact = sample_actions(tout, continuous, greedy=True)[0]
    jg = jax_sample(key, [jnp.asarray(a) for a in actor_out], continuous, greedy=True)[0]
    np.testing.assert_allclose(gact.numpy(), np.asarray(jg), **EXACTISH)
    # log-probs and entropies of given actions
    lp2, ent = log_prob_and_entropy(tout, act.float(), continuous)
    jlp2, jent = jax_lpe([jnp.asarray(a) for a in actor_out], jnp.asarray(act.numpy()).astype(jnp.float32), continuous)
    np.testing.assert_allclose(lp2.numpy(), np.asarray(jlp2), **EXACTISH)
    np.testing.assert_allclose(ent.numpy(), np.asarray(jent), **EXACTISH)
    # drawn from a generator: one draw per head, the actions valid
    g = torch.Generator().manual_seed(0)
    act_g = sample_actions(tout, continuous, generator=g)[0]
    if not continuous:
        assert all(0 <= int(act_g[:, i].min()) and int(act_g[:, i].max()) < d for i, d in enumerate(dims))


# --------------------------------------------------------------------------- losses and math


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_losses_match_jax(reduction):
    from sheeprl_tpu.algos.ppo import loss as jl
    from sheeprl_tpu_torch.algos.ppo import loss as tl

    rng = np.random.default_rng(6)
    a, b, c, d = (rng.normal(0, 1, 50).astype(np.float32) for _ in range(4))
    for clip in (0.1, 0.3):
        np.testing.assert_allclose(tl.policy_loss(t(a), t(b), t(c), clip, reduction).numpy(), np.asarray(jl.policy_loss(a, b, c, clip, reduction)), **EXACTISH)
        for clip_vloss in (False, True):
            np.testing.assert_allclose(
                tl.value_loss(t(a), t(b), t(c), clip, clip_vloss, reduction).numpy(),
                np.asarray(jl.value_loss(a, b, c, clip, clip_vloss, reduction)), **EXACTISH,
            )
    np.testing.assert_allclose(tl.entropy_loss(t(d), reduction).numpy(), np.asarray(jl.entropy_loss(d, reduction)), **EXACTISH)
    # a tensor clip coefficient, as the captured update reads it, gives the same
    np.testing.assert_allclose(tl.policy_loss(t(a), t(b), t(c), torch.tensor(0.1), reduction).numpy(), tl.policy_loss(t(a), t(b), t(c), 0.1, reduction).numpy())


def test_gae_matches_jax():
    from sheeprl_tpu.utils.utils import gae as jax_gae
    from sheeprl_tpu_torch.utils.utils import gae

    rng = np.random.default_rng(7)
    T, N = 20, 3
    rewards, values = (rng.normal(0, 1, (T, N, 1)).astype(np.float32) for _ in range(2))
    dones = (rng.random((T, N, 1)) < 0.2).astype(np.float32)
    next_value = rng.normal(0, 1, (N, 1)).astype(np.float32)
    jr, ja = jax_gae(rewards, values, dones, next_value, T, 0.99, 0.95)
    r, a = gae(t(rewards), t(values), t(dones), t(next_value), T, 0.99, 0.95)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)


def test_normalize_tensor_matches_jax_with_population_std():
    from sheeprl_tpu.utils.utils import normalize_tensor as jax_norm
    from sheeprl_tpu_torch.utils.utils import normalize_tensor

    x = np.random.default_rng(8).normal(3, 2, 9).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 1, 1, 1, 0], np.float32)
    want = np.asarray(jax_norm(jnp.asarray(x)))
    np.testing.assert_allclose(normalize_tensor(t(x)).numpy(), want, **EXACTISH)
    # torch.std's default (ddof 1) would miss it: 9 entries, a factor sqrt(8/9)
    ddof1 = ((t(x) - t(x).mean()) / (t(x).std() + 1e-8)).numpy()
    assert np.abs(ddof1 - want).max() > 1e-2
    np.testing.assert_allclose(normalize_tensor(t(x), mask=t(mask)).numpy(), np.asarray(jax_norm(jnp.asarray(x), mask=jnp.asarray(mask))), **EXACTISH)


def test_polynomial_decay_and_schedule_match_jax():
    import optax

    from sheeprl_tpu.utils.utils import polynomial_decay as jax_decay
    from sheeprl_tpu_torch.algos.ppo.ppo import polynomial_schedule
    from sheeprl_tpu_torch.utils.utils import polynomial_decay

    for step in (0, 1, 5, 10, 11):
        for power in (1.0, 2.0):
            assert polynomial_decay(step, initial=0.2, final=0.01, max_decay_steps=10, power=power) == jax_decay(
                step, initial=0.2, final=0.01, max_decay_steps=10, power=power
            )
    want = optax.polynomial_schedule(init_value=2.5e-4, end_value=1e-8, power=1.0, transition_steps=12)
    got = polynomial_schedule(2.5e-4, 1e-8, 1.0, 12)
    for count in (0, 1, 7, 12, 13):
        np.testing.assert_allclose(got(torch.tensor(count)).item(), float(want(count)), rtol=1e-7)


# --------------------------------------------------------------------------- attention and LSTM

ATTN_CASES = {"causal": dict(causal=True), "windowed": dict(causal=True, window=3), "segments": dict(causal=True, window=4, segments=True), "full": dict()}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_reference_attention_matches_jax(case):
    from sheeprl_tpu.ops.ring_attention import reference_attention as jax_attn
    from sheeprl_tpu_torch.ops.ring_attention import reference_attention

    kw = dict(ATTN_CASES[case])
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(0, 1, (2, 7, 2, 4)).astype(np.float32) for _ in range(3))
    seg = None
    if kw.pop("segments", False):
        seg = np.cumsum(rng.random((2, 7)) < 0.3, axis=1).astype(np.int32)
        seg[:, 3] = seg[:, 2] + 1  # a segment of one step
    want = np.asarray(jax_attn(q, k, v, segment_ids=None if seg is None else jnp.asarray(seg), **kw))
    got = reference_attention(t(q), t(k), t(v), segment_ids=None if seg is None else t(seg), **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_lstm_cell_matches_flax_optimized_lstm_cell():
    import flax.linen as nn

    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import LSTMCell

    rng = np.random.default_rng(10)
    x = rng.normal(0, 1, (5, 6)).astype(np.float32)
    c, h = (rng.normal(0, 1, (5, 8)).astype(np.float32) for _ in range(2))
    jcell = nn.OptimizedLSTMCell(8)
    params = perturbed(jcell.init(jax.random.PRNGKey(1), (c, h), x), 2)
    assert set(params["params"]) == {"ii", "if", "ig", "io", "hi", "hf", "hg", "ho"}
    (jc, jh), _ = jcell.apply(params, (c, h), x)
    cell = carry(params, LSTMCell(6, 8))
    tc, th = cell((t(c), t(h)), cell.project(t(x)))
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), **TOL)


# --------------------------------------------------------------------------- player and checkpoint layout


class _Envs:
    def step(self, actions):
        return actions


def test_pipelined_player_depth_zero_is_synchronous_and_depth_k_lags():
    from sheeprl_tpu_torch.rollout import PipelinedPlayer, rollout_metrics

    calls = []

    def policy(x):
        calls.append(x)
        return (torch.tensor([x * 10]),)

    sync = PipelinedPlayer(_Envs(), policy, depth=0)
    assert [int(sync.act(i)[0][0][0]) for i in range(4)] == [0, 10, 20, 30]
    lag = PipelinedPlayer(_Envs(), policy, lambda f: (int(f[0][0]), None), depth=2)
    # the first call's action while the pipeline fills, then the call's two calls ago
    assert [lag.act(i)[0] for i in range(6)] == [0, 0, 0, 10, 20, 30]
    assert lag.step(6)[2] == 40  # act then env_step with the action
    with pytest.raises(ValueError, match="pipeline_depth"):
        PipelinedPlayer(_Envs(), policy, depth=-1)
    assert rollout_metrics(_Envs()) == {}


def test_extract_policy_params_reads_the_host_loop_layout_and_refuses_others():
    from sheeprl_tpu_torch.utils.policy import extract_policy_params

    assert extract_policy_params({"params": {"w": 1}}, None, "ppo") == {"w": 1}
    with pytest.raises(NotImplementedError, match="carry"):
        extract_policy_params({"carry": {"params": {}}}, None, "ppo")
