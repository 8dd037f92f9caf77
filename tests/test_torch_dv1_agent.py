"""DreamerV1 agent of the PyTorch port against the JAX package, module by module.

Both packages build a tiny agent from the ``dreamer_v1_dummy`` exp; the JAX parameters,
perturbed with seeded noise, are carried into the port with ``params_from_jax``. Inputs
come from numpy with a seed, and the port is fed the normal noise and the Gumbel noise
JAX draws from its keys, since torch cannot reproduce JAX's random numbers.

Tolerances. Float32: the GRU cell atol 1e-6 (outputs of order 1, a few products of 16
terms), the rest atol = rtol = 1e-5 (the two packages sum in other orders). Bfloat16,
Flax's ``GRUCell`` at ``dtype=bfloat16`` against the port's cell in bfloat16 on the same
bf16-rounded inputs: both round each layer's product and each elementwise operation to
bfloat16, in orders that differ (XLA fuses the gate arithmetic); atol 1.6e-2, four units
of bfloat16's rounding (2^-8) at the state's magnitude of ~1. The furthest of 64 x 16
entries read 7.8e-3 on the CPU (seeds 0-3).
"""

import contextlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_dv2_agent import perturbed
from tests.test_torch_dv3_agent import OBS_SPACE, obs_batch, to_torch

TOL = dict(atol=1e-5, rtol=1e-5)
CELL_F32_ATOL = 1e-6
CELL_BF16_ATOL = 1.6e-2
TINY = ["exp=dreamer_v1_dummy", "env=discrete_dummy"]
ACTIONS_DIM = (2,)
STOCH, REC = 4, 16


def compose_pair(extra=()):
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.config.core import compose as torch_compose

    overrides = [*TINY, *extra]
    return jax_compose(overrides=overrides), torch_compose(overrides=[*overrides, "device=cpu"])


@contextlib.contextmanager
def jitted_init(*modules):
    """The reference's ``flax.linen.Module.init`` and its Xavier re-init (as each of
    ``modules`` imported it) under ``jax.jit``: the same values as eager, compiled once
    per call."""
    import flax.linen as nn

    from sheeprl_tpu.algos.dreamer_v2 import agent as dv2_agent

    eager_init, eager_xavier = nn.Module.init, dv2_agent._xavier_normal_init
    jitted = jax.jit(eager_xavier)

    def init(self, rngs, *args, **kwargs):
        return jax.jit(lambda r, *a: eager_init(self, r, *a, **kwargs))(rngs, *args)

    nn.Module.init = init
    for m in (dv2_agent, *modules):
        m._xavier_normal_init = jitted
    try:
        yield
    finally:
        nn.Module.init = eager_init
        for m in (dv2_agent, *modules):
            m._xavier_normal_init = eager_xavier


def jax_ctx(precision="fp32", seed=0):
    from sheeprl_tpu.parallel.mesh import MeshContext, build_mesh

    return MeshContext(mesh=build_mesh(devices=jax.devices()[:1]), precision=precision, seed=seed)


def build_pair(jcfg, tcfg, is_continuous=False, precision="fp32", seed=0, perturb=0.05):
    """JAX agent + port agent holding the same (perturbed) parameters."""
    from sheeprl_tpu.algos.dreamer_v1 import agent as jax_agent
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.parallel.context import RunContext, compute_dtype

    with jitted_init(jax_agent):
        jwm, jactor, jcritic, params, latent = jax_agent.build_agent(jax_ctx(precision, seed), ACTIONS_DIM, is_continuous, jcfg, OBS_SPACE)
    params = perturbed(params, seed + 100, perturb)
    port_ctx = RunContext(torch.device("cpu"), seed, compute_dtype=compute_dtype(precision))
    wm, actor, critic, _ = build_agent(port_ctx, ACTIONS_DIM, is_continuous, tcfg, OBS_SPACE)
    modules = {"world_model": wm, "actor": actor, "critic": critic}
    for name, state in params_from_jax(params, modules).items():
        modules[name].load_state_dict(state)
    return SimpleNamespace(jwm=jwm, jactor=jactor, jcritic=jcritic, params=params, modules=modules, latent=latent, **modules)


@pytest.fixture(scope="module")
def pair():
    return build_pair(*compose_pair())


def close(t, j, **kw):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **(kw or TOL))


def wm_apply(pair, method, *args):
    from sheeprl_tpu.algos.dreamer_v1.agent import WorldModelV1

    return jax.jit(lambda p, *a: pair.jwm.apply(p, *a, method=getattr(WorldModelV1, method)))(pair.params["world_model"], *args)


def test_agent_layout_and_init():
    """The port's modules hold the reference's parameter tree (``params_from_jax`` fills
    every entry, Flax's ``GRUCell`` layers included), and its own initialisation is
    DreamerV2's: Xavier-normal kernels, zero biases."""
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import FlaxGRUCell, build_agent
    from sheeprl_tpu_torch.parallel.context import RunContext

    _, tcfg = compose_pair()
    wm, actor, critic, latent = build_agent(RunContext(torch.device("cpu"), 0), ACTIONS_DIM, False, tcfg, OBS_SPACE)
    assert latent == STOCH + REC
    rnn = wm.rssm.recurrent_model.rnn
    assert isinstance(rnn, FlaxGRUCell)
    # a bias on the input layers and on hn only, as Flax's cell
    assert [n for n, _ in rnn.named_parameters() if n.endswith("bias")] == ["ir.bias", "iz.bias", "in_.bias", "hn.bias"]
    assert wm.rssm.representation_model.output_dim == 2 * STOCH
    assert not hasattr(wm, "continue_model")
    for m in wm.modules():
        if isinstance(m, torch.nn.Linear) and m.bias is not None:
            assert not m.bias.any()
    w = wm.rssm.recurrent_model.rnn.hr.weight
    std = np.sqrt(2.0 / sum(w.shape))
    assert abs(w.std().item() - std) < 0.3 * std


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_gru_cell_matches_flax(precision):
    """Flax's ``GRUCell`` against ``FlaxGRUCell`` on the same parameters and inputs, in
    float32 and in bfloat16 (the caller's bf16 state, every operation in bf16)."""
    import flax.linen as nn
    import jax.numpy as jnp

    from sheeprl_tpu_torch.algos.dreamer_v1.agent import FlaxGRUCell
    from sheeprl_tpu_torch.algos.dreamer_v3.params import module_state_from_jax
    from sheeprl_tpu_torch.models.blocks import set_compute_dtype

    dtype = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[precision]
    n_in, hidden, rows = 12, 16, 64
    rng = np.random.default_rng(0)
    cell = nn.GRUCell(features=hidden, dtype=dtype[0])
    x = rng.normal(size=(rows, n_in)).astype(np.float32)
    h = rng.uniform(-1, 1, size=(rows, hidden)).astype(np.float32)
    params = perturbed(cell.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x)), 1, 0.2)
    port = set_compute_dtype(FlaxGRUCell(n_in, hidden), dtype[1])
    port.load_state_dict(module_state_from_jax(params["params"], port))
    xj, hj = jnp.asarray(x).astype(dtype[0]), jnp.asarray(h).astype(dtype[0])
    ref, _ = jax.jit(cell.apply)(params, hj, xj)
    with torch.no_grad():
        out = port(torch.from_numpy(h).to(dtype[1]), torch.from_numpy(x).to(dtype[1]))
    assert out.dtype == dtype[1]
    close(out, np.asarray(ref.astype(jnp.float32)), atol=CELL_F32_ATOL if precision == "fp32" else CELL_BF16_ATOL, rtol=0)


def test_recurrent_model(pair):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(5, STOCH + 2)).astype(np.float32)
    h = rng.normal(size=(5, REC)).astype(np.float32)
    ref = jax.jit(lambda p, x, h: pair.jwm.apply(p, x, h, method=lambda m, x, h: m.rssm.recurrent_model(x, h)))(
        pair.params["world_model"], x, h
    )
    with torch.no_grad():
        close(pair.world_model.rssm.recurrent_model(torch.from_numpy(x), torch.from_numpy(h)), ref, atol=CELL_F32_ATOL * 4, rtol=1e-5)


def test_compute_stochastic_state():
    from sheeprl_tpu.algos.dreamer_v1.agent import compute_stochastic_state as jax_css
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import compute_stochastic_state

    rng = np.random.default_rng(2)
    info = rng.normal(0, 3, size=(6, 2 * STOCH)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    (jmean, jstd), jsample = jax_css(key, info, 0.1)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (6, STOCH))))
    (mean, std), sample = compute_stochastic_state(torch.from_numpy(info), 0.1, noise=noise)
    close(mean, jmean)
    close(std, jstd, atol=1e-6, rtol=1e-6)
    close(sample, jsample)
    (_, _), greedy = compute_stochastic_state(torch.from_numpy(info), 0.1, sample=False)
    (_, _), jgreedy = jax_css(None, info, 0.1)
    close(greedy, jgreedy)


def test_encoder_decoder_and_reward(pair):
    obs = obs_batch(np.random.default_rng(0), 3)
    with torch.no_grad():
        close(pair.world_model.encode(to_torch(obs)), wm_apply(pair, "encode", obs))
    latent = np.random.default_rng(3).normal(size=(2, 3, pair.latent)).astype(np.float32)
    jrec = wm_apply(pair, "decode", latent)
    with torch.no_grad():
        t = torch.from_numpy(latent)
        trec = pair.world_model.decode(t)
        close(pair.world_model.reward(t), wm_apply(pair, "reward", latent))
    assert set(trec) == set(jrec) == {"rgb", "state"}
    for k in jrec:
        close(trec[k], jrec[k])


def test_dynamic_with_injected_noise(pair):
    """One posterior step with no ``is_first`` reset: the state, the prior and posterior
    samples and their ``(mean, std)`` from JAX's own normal noise."""
    rng = np.random.default_rng(1)
    b = 4
    post = rng.normal(size=(b, STOCH)).astype(np.float32)
    h = rng.normal(size=(b, REC)).astype(np.float32)
    action = np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]
    embed = rng.normal(size=(b, pair.world_model.encoder.output_dim)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jh, jpost, jprior, (jpm, jps), (jqm, jqs) = wm_apply(pair, "dynamic", post, h, action, embed, key)
    k1, k2 = jax.random.split(key)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (b, STOCH)))) for k in (k1, k2))
    with torch.no_grad():
        th, tpost, tprior, (tpm, tps), (tqm, tqs) = pair.world_model.dynamic(
            *(torch.from_numpy(a) for a in (post, h, action, embed)), noise=noise
        )
    for t, j in ((th, jh), (tpost, jpost), (tprior, jprior), (tpm, jpm), (tps, jps), (tqm, jqm), (tqs, jqs)):
        close(t, j)


def test_imagination_with_injected_noise(pair):
    rng = np.random.default_rng(2)
    b = 8
    prior = rng.normal(size=(b, STOCH)).astype(np.float32)
    h = rng.normal(size=(b, REC)).astype(np.float32)
    action = np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]
    key = jax.random.PRNGKey(4)
    jimag, jh = wm_apply(pair, "imagination", prior, h, action, key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (b, STOCH))))
    with torch.no_grad():
        timag, th = pair.world_model.imagination(*(torch.from_numpy(a) for a in (prior, h, action)), noise=noise)
    close(th, jh)
    close(timag, jimag)


@pytest.mark.parametrize("greedy", [True, False])
def test_player_step_rollout_with_injected_draws(pair, greedy):
    """8 player steps on 4 envs, with an ``is_first`` reset of two envs at step 4; the
    sampled player with exploration noise at amount 0.5, every draw JAX's own."""
    from sheeprl_tpu.algos.dreamer_v1.agent import make_player_step as jax_make_player_step
    from sheeprl_tpu.algos.dreamer_v3.agent import PlayerState as JaxPlayerState
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import PlayerState, make_player_step

    b, steps, amount = 4, 8, 0.5
    rng = np.random.default_rng(5)
    jstep = jax.jit(jax_make_player_step(pair.jwm, pair.jactor, ACTIONS_DIM, False), static_argnames=("greedy",))
    jlatent_actor = jax.jit(lambda p, z, k: pair.jactor.apply(p, z, k)[0])
    tstep = make_player_step(pair.world_model, pair.actor, ACTIONS_DIM, False)
    zeros = lambda n: np.zeros((b, n), np.float32)  # noqa: E731
    jstate = JaxPlayerState(zeros(REC), zeros(STOCH), zeros(2))
    tstate = PlayerState(*(torch.from_numpy(x) for x in jstate))
    key = jax.random.PRNGKey(7)
    for t in range(steps):
        obs = obs_batch(rng, b)
        is_first = np.ones((b, 1), np.float32) if t == 0 else np.zeros((b, 1), np.float32)
        if t == 4:
            is_first[[0, 2]] = 1.0
        key, sub = jax.random.split(key)
        jactions, _, jstate = jstep(pair.params, jstate, obs, is_first, sub, amount, greedy=greedy)
        k_repr, k_act, k_expl = jax.random.split(sub, 3)
        stoch_noise = torch.from_numpy(np.array(jax.random.normal(k_repr, (b, STOCH))))
        action_draws = expl_draws = None
        if not greedy:
            jlatent = np.concatenate([np.asarray(jstate.stochastic_state), np.asarray(jstate.recurrent_state)], -1)
            action_draws = [torch.from_numpy(np.array(a)) for a in jlatent_actor(pair.params["actor"], jlatent, k_act)]
            _, k_sample, k_mask = jax.random.split(k_expl, 3)
            expl_draws = [(torch.from_numpy(np.array(jax.random.gumbel(k_sample, (b, 2)))), torch.from_numpy(np.array(jax.random.uniform(k_mask, (b,)))))]
        with torch.no_grad():
            tactions, _, tstate = tstep(
                tstate, to_torch(obs), torch.from_numpy(is_first), greedy=greedy, draws=(stoch_noise, action_draws, expl_draws), expl_amount=amount
            )
        close(tstate.recurrent_state, jstate.recurrent_state)
        close(tstate.stochastic_state, jstate.stochastic_state)
        np.testing.assert_array_equal(tactions[0].numpy().argmax(-1), np.asarray(jactions[0]).argmax(-1))
        close(tstate.actions, jstate.actions, atol=1e-6, rtol=0)  # straight-through one-hots
