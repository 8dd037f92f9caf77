"""DreamerV3 agent of the PyTorch port against the JAX package, module by module.

Both packages build a tiny agent from the same config; the JAX parameters (perturbed
with seeded noise, so that no head is all zeros and no LayerNorm is the identity) are
carried into the port with ``params_from_jax``. Inputs come from numpy with a seed, and
the port is fed the draws JAX made (its one-hot samples), since torch cannot reproduce
JAX's random numbers.

Tolerance: atol = rtol = 1e-4 in float32. The two packages sum in other orders (convs,
matmuls, LayerNorm statistics) and Flax's LayerNorm takes the variance as
``E[x^2] - E[x]^2``, which the port copies but whose rounding still differs. Greedy
actions must be equal.
"""

import contextlib
from types import SimpleNamespace

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

TOL = dict(atol=1e-4, rtol=1e-4)

TINY = [
    "exp=dreamer_v3_dummy",
    "algo=dreamer_v3_XS",
    "env=discrete_dummy",
    "env.screen_size=64",
    "algo.dense_units=16",
    "algo.mlp_layers=2",
    "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.world_model.recurrent_model.recurrent_state_size=32",
    "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4",
    "algo.world_model.reward_model.bins=15",
    "algo.critic.bins=15",
]
OBS_SPACE = gym.spaces.Dict(
    {
        "rgb": gym.spaces.Box(0, 255, (3, 64, 64), np.uint8),
        "state": gym.spaces.Box(-20, 20, (10,), np.float32),
    }
)
ACTIONS_DIM = (2,)
STOCH, DISCRETE, REC = 4, 4, 32


def compose_pair(extra=()):
    """The same composition in both packages' config trees."""
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.config.core import compose as torch_compose

    overrides = [*TINY, *extra]
    return jax_compose(overrides=overrides), torch_compose(overrides=[*overrides, "device=cpu"])


@contextlib.contextmanager
def _jitted_init():
    """Run the reference's ``flax.linen.Module.init`` and Hafner re-init under
    ``jax.jit`` for the duration: the same values as eager, compiled once per call
    instead of once per initialiser shape."""
    import flax.linen as nn

    from sheeprl_tpu.algos.dreamer_v3 import agent

    eager_init, eager_hafner = nn.Module.init, agent.apply_hafner_init

    def init(self, rngs, *args, **kwargs):
        return jax.jit(lambda r, *a: eager_init(self, r, *a, **kwargs))(rngs, *args)

    nn.Module.init = init
    agent.apply_hafner_init = jax.jit(eager_hafner)
    try:
        yield
    finally:
        nn.Module.init = eager_init
        agent.apply_hafner_init = eager_hafner


def build_pair(seed=0, perturb=0.05):
    """JAX agent + port agent holding the same (perturbed) parameters."""
    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
    from sheeprl_tpu.parallel.mesh import MeshContext, build_mesh
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.parallel.context import RunContext

    jcfg, tcfg = compose_pair()
    ctx = MeshContext(mesh=build_mesh(devices=jax.devices()[:1]), precision="fp32", seed=seed)
    with _jitted_init():
        jwm, jactor, jcritic, params, _ = jax_build_agent(ctx, ACTIONS_DIM, False, jcfg, OBS_SPACE)
    params = jax.device_get(params)
    if perturb:
        rng = np.random.default_rng(seed + 100)
        params = jax.tree.map(lambda x: (x + rng.normal(0.0, perturb, x.shape)).astype(np.float32), params)
    wm, actor, critic, target_critic, latent = build_agent(RunContext(torch.device("cpu"), seed), ACTIONS_DIM, False, tcfg, OBS_SPACE)
    modules = {"world_model": wm, "actor": actor, "critic": critic, "target_critic": target_critic}
    for name, state in params_from_jax(params, modules).items():
        modules[name].load_state_dict(state)
    return SimpleNamespace(
        jwm=jwm,
        jactor=jactor,
        jcritic=jcritic,
        # jitted: one compile per method instead of one per primitive shape
        jwm_apply=jax.jit(jwm.apply, static_argnames=("method",)),
        jcritic_apply=jax.jit(jcritic.apply),
        params=params,
        wm=wm,
        actor=actor,
        critic=critic,
        latent=latent,
    )


def obs_batch(rng, batch):
    return {
        "rgb": rng.integers(0, 256, size=(batch, 3, 64, 64), dtype=np.uint8),
        "state": rng.normal(0.0, 3.0, size=(batch, 10)).astype(np.float32),
    }


def to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(kw or TOL))


@pytest.fixture(scope="module")
def pair():
    with torch.no_grad():
        yield build_pair()


def test_encoder_rgb_and_state(pair):
    from sheeprl_tpu.algos.dreamer_v3.agent import WorldModel

    obs = obs_batch(np.random.default_rng(0), 3)
    ref = pair.jwm_apply(pair.params["world_model"], obs, method=WorldModel.encode)
    with torch.no_grad():
        out = pair.wm.encode(to_torch(obs))
    assert out.shape == ref.shape
    close(out, ref)


def test_initial_states(pair):
    from sheeprl_tpu.algos.dreamer_v3.agent import WorldModel

    h0, z0 = pair.jwm.apply(pair.params["world_model"], (2, 3), method=WorldModel.initial_states)
    with torch.no_grad():
        th0, tz0 = pair.wm.initial_states((2, 3))
    close(th0, h0)
    np.testing.assert_array_equal(tz0.numpy(), np.asarray(z0))


@pytest.mark.parametrize("fused", ["0", "1"])
def test_dynamic_with_injected_draws(pair, fused, monkeypatch):
    from sheeprl_tpu.algos.dreamer_v3.agent import WorldModel

    monkeypatch.setenv("SHEEPRL_TPU_FUSED_GRU", fused)
    rng = np.random.default_rng(1)
    b = 4
    post = np.eye(DISCRETE, dtype=np.float32)[rng.integers(0, DISCRETE, (b, STOCH))].reshape(b, -1)
    h = rng.normal(size=(b, REC)).astype(np.float32)
    action = np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]
    embed = rng.normal(size=(b, pair.wm.encoder.output_dim)).astype(np.float32)
    is_first = np.array([[1.0], [0.0], [0.0], [1.0]], np.float32)
    # a fresh jit per test: the kernel switch is read when the function is traced
    jdynamic = jax.jit(lambda *a: pair.jwm.apply(*a, method=WorldModel.dynamic))
    jout = jdynamic(pair.params["world_model"], post, h, action, embed, is_first, jax.random.PRNGKey(3))
    jh, jpost, jprior, jpost_logits, jprior_logits = jout
    draws = (torch.from_numpy(np.array(jprior)), torch.from_numpy(np.array(jpost).reshape(b, STOCH, DISCRETE)))
    with torch.no_grad():
        th, tpost, tprior, tpost_logits, tprior_logits = pair.wm.dynamic(
            *(torch.from_numpy(a) for a in (post, h, action, embed, is_first)), draws=draws
        )
    close(th, jh)
    close(tpost_logits, jpost_logits)
    close(tprior_logits, jprior_logits)
    close(tpost, jpost)
    close(tprior, jprior)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_imagination_with_injected_draws(pair, fused, monkeypatch):
    from sheeprl_tpu.algos.dreamer_v3.agent import WorldModel

    monkeypatch.setenv("SHEEPRL_TPU_FUSED_GRU", fused)
    rng = np.random.default_rng(2)
    b = 8
    prior = np.eye(DISCRETE, dtype=np.float32)[rng.integers(0, DISCRETE, (b, STOCH))].reshape(b, -1)
    h = rng.normal(size=(b, REC)).astype(np.float32)
    action = np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]
    jimagination = jax.jit(lambda *a: pair.jwm.apply(*a, method=WorldModel.imagination))
    jimag, jh = jimagination(pair.params["world_model"], prior, h, action, jax.random.PRNGKey(4))
    draw = torch.from_numpy(np.array(jimag).reshape(b, STOCH, DISCRETE))
    with torch.no_grad():
        timag, th = pair.wm.imagination(*(torch.from_numpy(a) for a in (prior, h, action)), draw=draw)
    close(th, jh)
    close(timag, jimag)


def test_decode_reward_continue(pair):
    from sheeprl_tpu.algos.dreamer_v3.agent import WorldModel

    latent = np.random.default_rng(3).normal(size=(2, 3, pair.latent)).astype(np.float32)
    p = pair.params["world_model"]
    jrec = pair.jwm_apply(p, latent, method=WorldModel.decode)
    with torch.no_grad():
        t = torch.from_numpy(latent)
        trec = pair.wm.decode(t)
        close(pair.wm.reward(t), pair.jwm_apply(p, latent, method=WorldModel.reward))
        close(pair.wm.continues(t), pair.jwm_apply(p, latent, method=WorldModel.continues))
    assert set(trec) == set(jrec) == {"rgb", "state"}
    for k in jrec:
        assert tuple(trec[k].shape) == tuple(jrec[k].shape)
        close(trec[k], jrec[k])


def test_actor_logits_greedy_actions_and_critic(pair):
    latent = np.random.default_rng(4).normal(size=(6, pair.latent)).astype(np.float32)
    jactions, jdists = pair.jactor.apply(pair.params["actor"], latent, None, True)
    jvalues = pair.jcritic_apply(pair.params["critic"], latent)
    with torch.no_grad():
        t = torch.from_numpy(latent)
        tactions, tdists = pair.actor(t, greedy=True)
        close(pair.critic(t), jvalues)
    close(tdists[0].logits, jdists[0].logits)
    np.testing.assert_array_equal(tactions[0].numpy(), np.asarray(jactions[0]))


@pytest.mark.parametrize("fused,greedy", [("0", True), ("1", True), ("1", False)])
def test_player_step_rollout_with_injected_draws(pair, fused, greedy, monkeypatch):
    """8 player steps on 4 envs, with an ``is_first`` reset of two envs at step 4."""
    from sheeprl_tpu.algos.dreamer_v3.agent import PlayerState as JaxPlayerState
    from sheeprl_tpu.algos.dreamer_v3.agent import WorldModel
    from sheeprl_tpu.algos.dreamer_v3.agent import make_player_step as jax_make_player_step
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerState, make_player_step

    monkeypatch.setenv("SHEEPRL_TPU_FUSED_GRU", fused)
    b, steps = 4, 8
    rng = np.random.default_rng(5)
    jposterior_logits = jax.jit(
        lambda p, h, e: pair.jwm.apply(p, h, e, None, False, method=WorldModel.representation)[0]
    )
    jstep = jax.jit(jax_make_player_step(pair.jwm, pair.jactor, ACTIONS_DIM, DISCRETE), static_argnames=("greedy",))
    tstep = make_player_step(pair.wm, pair.actor, ACTIONS_DIM, DISCRETE)
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
        jactions, _, jstate = jstep(pair.params, jstate, obs, is_first, sub, greedy=greedy)
        stoch_draw = torch.from_numpy(np.array(jstate.stochastic_state).reshape(b, STOCH, DISCRETE))
        action_draws = None if greedy else [torch.from_numpy(np.array(a)) for a in jactions]
        with torch.no_grad():
            tactions, _, tstate = tstep(
                tstate, to_torch(obs), torch.from_numpy(is_first), greedy=greedy, draws=(stoch_draw, action_draws)
            )
        close(tstate.recurrent_state, jstate.recurrent_state)
        close(tstate.stochastic_state, jstate.stochastic_state)
        np.testing.assert_array_equal(tactions[0].numpy().argmax(-1), np.asarray(jactions[0]).argmax(-1))
        # posterior logits from each side's own recurrent state
        wm_p = pair.params["world_model"]
        jembed = pair.jwm_apply(wm_p, obs, method=WorldModel.encode)
        jlogits = jposterior_logits(wm_p, jstate.recurrent_state, jembed)
        with torch.no_grad():
            tlogits, _ = pair.wm.representation(tstate.recurrent_state, pair.wm.encode(to_torch(obs)), sample=False)
        close(tlogits, jlogits)
