"""DreamerV2 agent of the PyTorch port against the JAX package, module by module.

Both packages build a tiny agent from the ``dreamer_v2_dummy`` exp (the conv trunk four
channels wide) with every LayerNorm on (``algo.layer_norm=True``: the conv and MLP norms and the bias-free convs; the
train-step tests run the default, without them). The JAX parameters, perturbed with
seeded noise so that no LayerNorm is the identity, are carried into the port with
``params_from_jax``. Inputs come from numpy with a seed, and the port is fed the draws
JAX made (its one-hot samples, its Gumbel and normal noise), since torch cannot
reproduce JAX's random numbers. The JAX GRU cell runs its plain path and, where a test
is marked so, its Pallas kernel in interpret mode (``SHEEPRL_TPU_FUSED_GRU=1``).

Tolerance: float32, atol = rtol = 1e-5 (the two packages sum in other orders; the
outputs here are of order 1). Greedy actions must be equal, and sampled ones pick the
same class (a straight-through one-hot is ``one_hot + p - p``, one to within 1e-6).
"""

import contextlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_dv3_agent import OBS_SPACE, obs_batch, to_torch

TOL = dict(atol=1e-5, rtol=1e-5)
# four channels at the first conv: a LayerNorm over the dummy exp's two amplifies the
# packages' rounding differences some hundredfold
TINY = ["exp=dreamer_v2_dummy", "env=discrete_dummy", "algo.layer_norm=True", "algo.world_model.encoder.cnn_channels_multiplier=4"]
ACTIONS_DIM = (2,)
STOCH, DISCRETE, REC = 4, 4, 16


def compose_pair(extra=()):
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.config.core import compose as torch_compose

    overrides = [*TINY, *extra]
    return jax_compose(overrides=overrides), torch_compose(overrides=[*overrides, "device=cpu"])


@contextlib.contextmanager
def jitted_init():
    """The reference's ``flax.linen.Module.init`` and its Xavier re-init under
    ``jax.jit``: the same values as eager, compiled once per call."""
    import flax.linen as nn

    from sheeprl_tpu.algos.dreamer_v2 import agent

    eager_init, eager_xavier = nn.Module.init, agent._xavier_normal_init

    def init(self, rngs, *args, **kwargs):
        return jax.jit(lambda r, *a: eager_init(self, r, *a, **kwargs))(rngs, *args)

    nn.Module.init = init
    agent._xavier_normal_init = jax.jit(eager_xavier)
    try:
        yield
    finally:
        nn.Module.init = eager_init
        agent._xavier_normal_init = eager_xavier


def perturbed(params, seed: int, scale: float):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (x + rng.normal(0.0, scale, x.shape)).astype(np.float32), jax.device_get(params))


def build_pair(jcfg, tcfg, is_continuous=False, precision="fp32", seed=0, perturb=0.05):
    """JAX agent + port agent holding the same (perturbed) parameters."""
    from sheeprl_tpu.algos.dreamer_v2.agent import build_agent as jax_build_agent
    from sheeprl_tpu.parallel.mesh import MeshContext, build_mesh
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.parallel.context import RunContext, compute_dtype

    ctx = MeshContext(mesh=build_mesh(devices=jax.devices()[:1]), precision=precision, seed=seed)
    with jitted_init():
        jwm, jactor, jcritic, params, latent = jax_build_agent(ctx, ACTIONS_DIM, is_continuous, jcfg, OBS_SPACE)
    params = perturbed(params, seed + 100, perturb)
    port_ctx = RunContext(torch.device("cpu"), seed, compute_dtype=compute_dtype(precision))
    wm, actor, critic, target_critic, _ = build_agent(port_ctx, ACTIONS_DIM, is_continuous, tcfg, OBS_SPACE)
    modules = {"world_model": wm, "actor": actor, "critic": critic, "target_critic": target_critic}
    for name, state in params_from_jax(params, modules).items():
        modules[name].load_state_dict(state)
    return SimpleNamespace(jwm=jwm, jactor=jactor, jcritic=jcritic, params=params, modules=modules, latent=latent, **modules)


@pytest.fixture(scope="module")
def pair():
    return build_pair(*compose_pair())


def close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(kw or TOL))


def wm_apply(pair, method, *args):
    from sheeprl_tpu.algos.dreamer_v2.agent import WorldModelV2

    return jax.jit(lambda p, *a: pair.jwm.apply(p, *a, method=getattr(WorldModelV2, method)))(pair.params["world_model"], *args)


def test_agent_layout_and_init():
    """The port's modules hold the reference's parameter tree (``params_from_jax`` fills
    every entry), and its own initialisation is the reference's: Xavier-normal kernels
    (std by both fans), zero biases, unit LayerNorms."""
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
    from sheeprl_tpu_torch.parallel.context import RunContext

    _, tcfg = compose_pair()
    wm, actor, critic, target, latent = build_agent(RunContext(torch.device("cpu"), 0), ACTIONS_DIM, False, tcfg, OBS_SPACE)
    assert latent == STOCH * DISCRETE + REC
    assert wm.encoder.output_dim == 2 * 2 * 4 * 8 + 8  # the VALID trunk's 2x2x8m, then the vector stack
    for m in wm.modules():
        if isinstance(m, torch.nn.Linear):
            assert m.bias is None or not m.bias.any()
    torch.testing.assert_close(target.state_dict(), critic.state_dict())
    rnn = wm.rssm.recurrent_model.rnn
    assert (rnn.ln_scale == 1).all() and (rnn.ln_bias == 0).all() and rnn.norm_eps == 1e-3
    w = wm.rssm.repr_logits.weight
    std = np.sqrt(2.0 / sum(w.shape))
    assert abs(w.std().item() - std) < 0.3 * std


def test_encoder(pair):
    obs = obs_batch(np.random.default_rng(0), 3)
    ref = wm_apply(pair, "encode", obs)
    with torch.no_grad():
        out = pair.world_model.encode(to_torch(obs))
    assert out.shape == ref.shape
    close(out, ref)


def test_decoder_and_reward(pair):
    latent = np.random.default_rng(3).normal(size=(2, 3, pair.latent)).astype(np.float32)
    jrec = wm_apply(pair, "decode", latent)
    with torch.no_grad():
        t = torch.from_numpy(latent)
        trec = pair.world_model.decode(t)
        close(pair.world_model.reward(t), wm_apply(pair, "reward", latent))
    assert set(trec) == set(jrec) == {"rgb", "state"}
    for k in jrec:
        assert tuple(trec[k].shape) == tuple(jrec[k].shape)
        close(trec[k], jrec[k])


def test_recurrent_model(pair):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(5, STOCH * DISCRETE + 2)).astype(np.float32)
    h = rng.normal(size=(5, REC)).astype(np.float32)
    ref = jax.jit(lambda p, x, h: pair.jwm.apply(p, x, h, method=lambda m, x, h: m.rssm.recurrent_model(x, h)))(
        pair.params["world_model"], x, h
    )
    with torch.no_grad():
        close(pair.world_model.rssm.recurrent_model(torch.from_numpy(x), torch.from_numpy(h)), ref)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_dynamic_with_injected_draws(pair, fused, monkeypatch):
    monkeypatch.setenv("SHEEPRL_TPU_FUSED_GRU", fused)
    rng = np.random.default_rng(1)
    b = 4
    post = np.eye(DISCRETE, dtype=np.float32)[rng.integers(0, DISCRETE, (b, STOCH))].reshape(b, -1)
    h = rng.normal(size=(b, REC)).astype(np.float32)
    action = np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]
    embed = rng.normal(size=(b, pair.world_model.encoder.output_dim)).astype(np.float32)
    is_first = np.array([[1.0], [0.0], [0.0], [1.0]], np.float32)
    jh, jpost, jprior, jpost_logits, jprior_logits = wm_apply(pair, "dynamic", post, h, action, embed, is_first, jax.random.PRNGKey(3))
    draws = (torch.from_numpy(np.array(jprior)), torch.from_numpy(np.array(jpost).reshape(b, STOCH, DISCRETE)))
    with torch.no_grad():
        th, tpost, tprior, tpost_logits, tprior_logits = pair.world_model.dynamic(
            *(torch.from_numpy(a) for a in (post, h, action, embed, is_first)), draws=draws
        )
    close(th, jh)
    close(tpost_logits, jpost_logits)
    close(tprior_logits, jprior_logits)
    close(tpost, jpost)
    close(tprior, jprior)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_imagination_with_injected_gumbel(pair, fused, monkeypatch):
    """The prior sampled from JAX's own Gumbel noise (``jax.random.categorical``'s)."""
    monkeypatch.setenv("SHEEPRL_TPU_FUSED_GRU", fused)
    rng = np.random.default_rng(2)
    b = 8
    prior = np.eye(DISCRETE, dtype=np.float32)[rng.integers(0, DISCRETE, (b, STOCH))].reshape(b, -1)
    h = rng.normal(size=(b, REC)).astype(np.float32)
    action = np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]
    key = jax.random.PRNGKey(4)
    jimag, jh = wm_apply(pair, "imagination", prior, h, action, key)
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(key, (b, STOCH, DISCRETE))))
    with torch.no_grad():
        timag, th = pair.world_model.imagination(*(torch.from_numpy(a) for a in (prior, h, action)), gumbel=gumbel)
    close(th, jh)
    close(timag, jimag)


def test_discrete_actor_and_critic(pair):
    latent = np.random.default_rng(4).normal(size=(6, pair.latent)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jgreedy, jdists = pair.jactor.apply(pair.params["actor"], latent, None, True)
    jsampled, _ = pair.jactor.apply(pair.params["actor"], latent, key)
    gumbels = [torch.from_numpy(np.array(jax.random.gumbel(k, (6, d)))) for k, d in zip(jax.random.split(key, 1), ACTIONS_DIM)]
    jvalues = pair.jcritic.apply(pair.params["critic"], latent)
    with torch.no_grad():
        t = torch.from_numpy(latent)
        tgreedy, tdists = pair.actor(t, greedy=True)
        tsampled, _ = pair.actor(t, gumbels=gumbels)
        close(pair.critic(t), jvalues)
    close(tdists[0].logits, jdists[0].logits)
    np.testing.assert_array_equal(tgreedy[0].numpy(), np.asarray(jgreedy[0]))
    # a straight-through sample is ``one_hot + p - p``: one-hot to a rounding
    close(tsampled[0], jsampled[0], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tsampled[0].numpy().argmax(-1), np.asarray(jsampled[0]).argmax(-1))


@pytest.mark.parametrize("distribution", ["auto", "tanh_normal", "normal"])
def test_continuous_actor(distribution):
    """The continuous heads (``auto`` is ``trunc_normal``): the distribution's
    parameters, the greedy action, a sample from JAX's noise, log-prob and entropy."""
    from sheeprl_tpu.algos.dreamer_v2.agent import ActorV2 as JaxActorV2
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import ActorV2
    from sheeprl_tpu_torch.algos.dreamer_v3.params import module_state_from_jax

    latent_size, n = 32, 6
    kw = dict(dense_units=8, mlp_layers=2, layer_norm=True, init_std=0.3, min_std=0.1)
    jactor = JaxActorV2(actions_dim=(3,), is_continuous=True, distribution=distribution, **kw)
    params = perturbed(jactor.init(jax.random.PRNGKey(0), np.zeros((1, latent_size), np.float32)), 7, 0.3)
    actor = ActorV2(latent_size, (3,), True, distribution, **kw)
    actor.load_state_dict(module_state_from_jax(params["params"], actor))
    latent = np.random.default_rng(8).normal(size=(n, latent_size)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    (jgreedy,), (jdist,) = jactor.apply(params, latent, None, True)
    (jsample,), _ = jactor.apply(params, latent, key)
    if actor.distribution == "trunc_normal":
        noise = jax.random.uniform(key, (n, 3), minval=1e-5, maxval=1 - 1e-5)
    else:
        noise = jax.random.normal(key, (n, 3))
    with torch.no_grad():
        t = torch.from_numpy(latent)
        (tgreedy,), (tdist,) = actor(t, greedy=True)
        (tsample,), _ = actor(t, draws=[torch.from_numpy(np.array(noise))])
        close(tgreedy, jgreedy)
        close(tsample, jsample, atol=1e-5, rtol=1e-4)
        x = np.clip(np.asarray(jsample), -0.99, 0.99)
        close(tdist.log_prob(torch.from_numpy(x)), jdist.log_prob(x), atol=1e-4, rtol=1e-5)
        close(tdist.entropy(), jdist.entropy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("is_continuous", [False, True])
def test_exploration_noise_with_jax_draws(is_continuous):
    from sheeprl_tpu.algos.dreamer_v2.agent import add_exploration_noise as jax_noise
    from sheeprl_tpu.algos.dreamer_v2.agent import exploration_amount as jax_amount
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import add_exploration_noise, exploration_amount

    for args in ((0.3, 0.0, 0.0, 100), (0.8, 1000.0, 0.05, 2500), (0.8, 10.0, 0.05, 2500)):
        assert exploration_amount(*args) == jax_amount(*args)
    rng = np.random.default_rng(10)
    n, key, amount = 64, jax.random.PRNGKey(11), 0.5
    if is_continuous:
        actions = (rng.uniform(-1, 1, (n, 3)).astype(np.float32),)
        draws = [torch.from_numpy(np.array(jax.random.normal(key, (n, 3))))]
    else:
        actions = tuple(np.eye(d, dtype=np.float32)[rng.integers(0, d, n)] for d in (3, 2))
        draws, k = [], key
        for a in actions:
            k, k_sample, k_mask = jax.random.split(k, 3)
            draws.append((torch.from_numpy(np.array(jax.random.gumbel(k_sample, a.shape))), torch.from_numpy(np.array(jax.random.uniform(k_mask, a.shape[:1])))))
    ref = jax_noise(actions, np.float32(amount), key, is_continuous)
    out = add_exploration_noise([torch.from_numpy(a) for a in actions], amount, is_continuous, draws=draws)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        close(o, r, atol=1e-6, rtol=1e-6)
    if not is_continuous:
        assert any(not np.array_equal(o.numpy(), a) for o, a in zip(out, actions)), "no action was resampled"
    unchanged = add_exploration_noise([torch.from_numpy(a) for a in actions], 0.0, is_continuous)
    np.testing.assert_array_equal(torch.cat(unchanged, -1).numpy(), np.concatenate(actions, -1))


@pytest.mark.parametrize("greedy", [True, False])
def test_player_step_rollout_with_injected_draws(pair, greedy):
    """8 player steps on 4 envs, with an ``is_first`` reset of two envs at step 4; the
    sampled player with exploration noise at amount 0.5, every draw JAX's own."""
    from sheeprl_tpu.algos.dreamer_v3.agent import PlayerState as JaxPlayerState
    from sheeprl_tpu.algos.dreamer_v2.agent import WorldModelV2
    from sheeprl_tpu.algos.dreamer_v2.agent import make_player_step as jax_make_player_step
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import PlayerState, make_player_step

    b, steps, amount = 4, 8, 0.5
    rng = np.random.default_rng(5)
    jstep = jax.jit(jax_make_player_step(pair.jwm, pair.jactor, ACTIONS_DIM, False), static_argnames=("greedy",))
    jlatent_actor = jax.jit(lambda p, z, k: pair.jactor.apply(p, z, k)[0])
    jposterior_logits = jax.jit(lambda p, h, e: pair.jwm.apply(p, h, e, None, False, method=WorldModelV2.representation)[0])
    tstep = make_player_step(pair.world_model, pair.actor, ACTIONS_DIM, False)
    zeros = lambda n: np.zeros((b, n), np.float32)  # noqa: E731
    jstate = JaxPlayerState(zeros(REC), zeros(STOCH * DISCRETE), zeros(2))
    tstate = PlayerState(*(torch.from_numpy(x) for x in jstate))
    key = jax.random.PRNGKey(7)
    for t in range(steps):
        obs = obs_batch(rng, b)
        is_first = np.ones((b, 1), np.float32) if t == 0 else np.zeros((b, 1), np.float32)
        if t == 4:
            is_first[[0, 2]] = 1.0
        key, sub = jax.random.split(key)
        jactions, _, jstate = jstep(pair.params, jstate, obs, is_first, sub, amount, greedy=greedy)
        stoch_draw = torch.from_numpy(np.array(jstate.stochastic_state).reshape(b, STOCH, DISCRETE))
        action_draws = expl_draws = None
        if not greedy:
            _, k_act, k_expl = jax.random.split(sub, 3)
            jlatent = np.concatenate([np.asarray(jstate.stochastic_state), np.asarray(jstate.recurrent_state)], -1)
            action_draws = [torch.from_numpy(np.array(a)) for a in jlatent_actor(pair.params["actor"], jlatent, k_act)]
            _, k_sample, k_mask = jax.random.split(k_expl, 3)
            expl_draws = [(torch.from_numpy(np.array(jax.random.gumbel(k_sample, (b, 2)))), torch.from_numpy(np.array(jax.random.uniform(k_mask, (b,)))))]
        with torch.no_grad():
            tactions, _, tstate = tstep(
                tstate, to_torch(obs), torch.from_numpy(is_first), greedy=greedy, draws=(stoch_draw, action_draws, expl_draws), expl_amount=amount
            )
        close(tstate.recurrent_state, jstate.recurrent_state)
        close(tstate.stochastic_state, jstate.stochastic_state)
        np.testing.assert_array_equal(tactions[0].numpy().argmax(-1), np.asarray(jactions[0]).argmax(-1))
        close(tstate.actions, jstate.actions, atol=1e-6, rtol=0)  # straight-through one-hots
        # posterior logits from each side's own recurrent state
        wm_p = pair.params["world_model"]
        jlogits = jposterior_logits(wm_p, jstate.recurrent_state, wm_apply(pair, "encode", obs))
        with torch.no_grad():
            tlogits, _ = pair.world_model.representation(tstate.recurrent_state, pair.world_model.encode(to_torch(obs)), sample=False)
        close(tlogits, jlogits)
