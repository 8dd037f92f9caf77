"""The SAC family's modules in the PyTorch port against the JAX package: the tanh-Normal's
``sample_and_log_prob``, the SAC actor, the critic ensembles of SAC, DroQ (deterministic
and with the JAX side's own dropout masks) and SAC-AE, the losses, SAC-AE's encoder and
decoder (stride 2, Flax's ``SAME`` padding), ``preprocess_obs``, ``params_from_jax`` over
the whole parameter trees (ensembles, LayerNorms, convolutions, the 0-d ``log_alpha``,
the target trees) and the device transition ring.

Parameters are the JAX package's (perturbed with seeded noise, so that no bias is zero),
carried into the port with ``params_from_jax``; inputs come from numpy with a seed;
draws are JAX's own (``jax.random.normal`` from the key the reference uses; DroQ's
dropout masks recovered from ``flax.linen.Dropout`` by ``nn.intercept_methods``).
Tolerances, float32: forward outputs atol = rtol = 1e-5 (``TOL``), elementwise maths and
losses 1e-6 (``EXACTISH``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.envs import spaces as tspaces

TOL = dict(atol=1e-5, rtol=1e-5)
EXACTISH = dict(atol=1e-6, rtol=1e-6)
OBS, ACT, B, SCREEN = 5, 2, 4, 16
TINY = {
    "sac": ["exp=sac", "algo.hidden_size=8"],
    "droq": ["exp=droq", "algo.hidden_size=8"],
    "sac_ae": ["exp=sac_ae", f"env.screen_size={SCREEN}", "algo.mlp_keys.encoder=[]", "algo.encoder.features_dim=8",
               "algo.encoder.channels=4", "algo.actor.dense_units=8", "algo.critic.dense_units=8"],
}
COMMON = ["env=continuous_dummy", "algo.per_rank_batch_size=4", "env.num_envs=2"]


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def t(x):
    return torch.from_numpy(np.array(x))


def perturbed(params, seed: int, scale: float = 0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + rng.normal(0.0, scale, np.shape(x))).astype(np.float32), jax.device_get(params))


def overrides(algo: str, precision: str = "32-true", extra=()):
    keys = [] if algo == "sac_ae" else ["algo.mlp_keys.encoder=[state]"]
    return [*TINY[algo], *COMMON, *keys, f"mesh.precision={precision}", *extra]


def spaces(algo: str):
    """The observation and action spaces in gymnasium (JAX) and in the port."""
    from sheeprl_tpu.analysis.ir.synth import box_act_space, pixel_space, vector_space

    if algo == "sac_ae":
        obs_j, obs_t = pixel_space(size=SCREEN), tspaces.Dict({"rgb": tspaces.Box(0, 255, (3, SCREEN, SCREEN), np.uint8)})
    else:
        obs_j, obs_t = vector_space(OBS), tspaces.Dict({"state": tspaces.Box(-20, 20, (OBS,), np.float32)})
    return obs_j, obs_t, box_act_space(ACT), tspaces.Box(-1, 1, (ACT,), np.float32)


def jax_droq_agent(ctx, cfg):
    """DroQ's modules and parameters as the reference's ``main`` builds them."""
    from sheeprl_tpu.algos.droq.droq import DroQCriticEnsemble
    from sheeprl_tpu.algos.sac.agent import SACActor

    actor = SACActor(act_dim=ACT, hidden_size=cfg.algo.actor.hidden_size, dtype=ctx.compute_dtype)
    critic = DroQCriticEnsemble(n_critics=cfg.algo.critic.n, hidden_size=cfg.algo.critic.hidden_size, dropout=cfg.algo.critic.dropout, dtype=ctx.compute_dtype)
    obs, act = jnp.zeros((1, OBS)), jnp.zeros((1, ACT))
    params = {
        "actor": actor.init(jax.random.PRNGKey(1), obs),
        "critic": critic.init({"params": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)}, obs, act),
        "log_alpha": jnp.asarray(jnp.log(cfg.algo.alpha.alpha), dtype=jnp.float32),
    }
    params["critic_target"] = jax.tree.map(lambda x: x, params["critic"])
    return actor, critic, params


def agent_pair(algo: str, precision: str = "32-true", extra=(), seed: int = 0):
    """``(jax modules, perturbed JAX params, port agent over them, jax cfg, port cfg)``.
    The JAX modules: ``(actor, critic)`` or SAC-AE's ``(encoder, decoder, critic,
    actor)``."""
    from sheeprl_tpu.analysis.ir.synth import compose_tiny, tiny_ctx
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.parallel.context import RunContext, compute_dtype

    ov = overrides(algo, precision, extra)
    jcfg, tcfg = compose_tiny(ov), compose(overrides=[*ov, "device=cpu"])
    ctx = tiny_ctx(jcfg, seed)
    tctx = RunContext(torch.device("cpu"), seed, compute_dtype(precision))
    obs_j, obs_t, act_j, act_t = spaces(algo)
    if algo == "sac":
        from sheeprl_tpu.algos.sac.agent import build_agent as jbuild
        from sheeprl_tpu_torch.algos.sac.agent import build_agent

        *mods, params = jbuild(ctx, act_j, obs_j, jcfg)
    elif algo == "droq":
        from sheeprl_tpu_torch.algos.droq.droq import build_agent

        *mods, params = jax_droq_agent(ctx, jcfg)
    else:
        from sheeprl_tpu.algos.sac_ae.agent import build_agent as jbuild
        from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent

        *mods, params = jbuild(ctx, act_j, obs_j, jcfg)
    params = perturbed(params, 100 + seed)
    agent = build_agent(tctx, act_t, obs_t, tcfg)
    agent.load_state_dict(params_from_jax({"agent": params}, {"agent": agent})["agent"])
    return mods, params, agent, jcfg, tcfg


class DropoutMasks:
    """The keep-masks ``flax.linen.Dropout`` draws, recorded in call order (per layer, the
    members in order: ``nn.vmap`` runs a callback once per member) by
    ``nn.intercept_methods``; a deterministic call records nothing."""

    def __init__(self):
        self.masks = []

    def __call__(self, next_fun, args, kwargs, context):
        import flax.linen as nn

        out = next_fun(*args, **kwargs)
        module = context.module
        if isinstance(module, nn.Dropout) and context.method_name == "__call__":
            deterministic = kwargs.get("deterministic", module.deterministic)
            if not deterministic and module.rate > 0:
                jax.debug.callback(lambda m: self.masks.append(np.asarray(m)), out != 0)
        return out

    def noise(self, n_critics: int, start: int = 0):
        """Two layers' ``[n, B, hidden]`` dropout draws for the port (0 keeps, 1 drops)
        from the masks recorded at ``start``."""
        m = self.masks[start : start + 2 * n_critics]
        return tuple(t(np.where(np.stack(m[i * n_critics : (i + 1) * n_critics]), 0.0, 1.0).astype(np.float32)) for i in range(2))


def test_tanh_normal_sample_and_log_prob_matches_jax():
    from sheeprl_tpu.distributions import TanhNormal as JTanh
    from sheeprl_tpu_torch.distributions import TanhNormal

    rng = np.random.default_rng(0)
    loc = rng.normal(0, 2, (6, 3)).astype(np.float32)
    loc[:2] += 9.0  # pre-tanh draws far out, where tanh saturates in float32
    scale = np.exp(rng.normal(0, 0.5, (6, 3))).astype(np.float32)
    key = jax.random.PRNGKey(4)
    act_j, logp_j = JTanh(jnp.asarray(loc), jnp.asarray(scale)).sample_and_log_prob(key)
    noise = t(jax.random.normal(key, loc.shape))
    dist = TanhNormal(t(loc), t(scale))
    act, logp = dist.sample_and_log_prob(noise=noise)
    np.testing.assert_allclose(act.numpy(), np.asarray(act_j), **EXACTISH)
    np.testing.assert_allclose(logp.numpy(), np.asarray(logp_j), atol=1e-5, rtol=1e-5)
    # the pre-tanh path is not the clamped one: they part where |action| nears 1
    far = (act.abs() > 1 - 1e-6)
    assert far.any()
    assert not torch.allclose(logp[far], dist.log_prob(act)[far], atol=1e-2)


def test_sac_actor_matches_jax():
    (jactor, _), params, agent, _, _ = agent_pair("sac")
    obs = np.random.default_rng(1).normal(0, 2, (B, OBS)).astype(np.float32)
    mean_j, log_std_j = jax.jit(jactor.apply)(params["actor"], obs)
    mean, log_std = agent.actor(t(obs))
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(mean_j), **TOL)
    np.testing.assert_allclose(log_std.detach().numpy(), np.asarray(log_std_j), **TOL)
    assert log_std.min() >= -5.0 and log_std.max() <= 2.0


@pytest.mark.parametrize("case", ["sac", "droq", "droq_dropout", "sac_ae"])
def test_critic_ensembles_match_jax(case):
    import flax.linen as nn

    algo = case.removesuffix("_dropout")
    mods, params, agent, jcfg, _ = agent_pair(algo, extra=["algo.critic.dropout=0.3"] if case == "droq_dropout" else ())
    jcritic = mods[2] if algo == "sac_ae" else mods[1]
    feat = jcfg.algo.encoder.features_dim if algo == "sac_ae" else OBS
    rng = np.random.default_rng(2)
    obs = rng.normal(0, 2, (B, feat)).astype(np.float32)
    act = rng.uniform(-1, 1, (B, ACT)).astype(np.float32)
    masks, noise = DropoutMasks(), None
    if case == "droq_dropout":
        with nn.intercept_methods(masks):
            want = jcritic.apply(params["critic"], obs, act, False, rngs={"dropout": jax.random.PRNGKey(9)})
        noise = masks.noise(jcfg.algo.critic.n)
        assert 0 < float(noise[0].mean()) < 1  # some units dropped, some kept
        got = agent.critic(t(obs), t(act), noise)
    else:
        want = jax.jit(jcritic.apply)(params["critic"], obs, act)
        got = agent.critic(t(obs), t(act))
    assert got.shape == (jcfg.algo.critic.n, B, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    target = agent.critic_target if algo != "sac_ae" else agent.target_critic
    target_params = params["critic_target"] if algo != "sac_ae" else params["target_critic"]
    if case != "droq_dropout":
        np.testing.assert_allclose(target(t(obs), t(act)).detach().numpy(), np.asarray(jax.jit(jcritic.apply)(target_params, obs, act)), **TOL)


def test_losses_match_jax():
    from sheeprl_tpu.algos.sac import loss as jl
    from sheeprl_tpu_torch.algos.sac import loss as tl

    rng = np.random.default_rng(3)
    qs, target = rng.normal(0, 1, (2, B, 1)).astype(np.float32), rng.normal(0, 1, (B, 1)).astype(np.float32)
    logp, min_q = rng.normal(0, 1, (B, 1)).astype(np.float32), rng.normal(0, 1, (B, 1)).astype(np.float32)
    np.testing.assert_allclose(tl.critic_loss(t(qs), t(target)).item(), float(jl.critic_loss(qs, target)), **EXACTISH)
    np.testing.assert_allclose(tl.actor_loss(torch.tensor(0.7), t(logp), t(min_q)).item(), float(jl.actor_loss(0.7, logp, min_q)), **EXACTISH)
    log_alpha = torch.tensor(-0.3, requires_grad=True)
    lp = t(logp).requires_grad_()
    loss = tl.alpha_loss(log_alpha, lp, -2.0)
    np.testing.assert_allclose(loss.item(), float(jl.alpha_loss(jnp.float32(-0.3), logp, -2.0)), **EXACTISH)
    g_alpha, g_logp = torch.autograd.grad(loss, [log_alpha, lp], allow_unused=True)
    want = jax.grad(lambda la: jl.alpha_loss(la, logp, -2.0))(jnp.float32(-0.3))
    np.testing.assert_allclose(g_alpha.item(), float(want), **EXACTISH)
    assert g_logp is None  # no gradient into the log-probs


@pytest.mark.parametrize("screen", [16, 64])
def test_sac_ae_encoder_and_decoder_match_jax(screen):
    from sheeprl_tpu.algos.sac_ae.agent import AEDecoder as JDec
    from sheeprl_tpu.algos.sac_ae.agent import AEEncoder as JEnc
    from sheeprl_tpu_torch.algos.dreamer_v3.params import module_state_from_jax
    from sheeprl_tpu_torch.algos.sac_ae.agent import AEDecoder, AEEncoder

    rng = np.random.default_rng(screen)
    x = rng.random((3, 3, screen, screen)).astype(np.float32)
    jenc = JEnc(latent_dim=8, channels=4, screen_size=screen)
    p = perturbed(jenc.init(jax.random.PRNGKey(0), x), 1)
    enc = AEEncoder(3, 8, 4, screen)
    enc.load_state_dict(module_state_from_jax(p["params"], enc))
    np.testing.assert_allclose(enc(t(x)).detach().numpy(), np.asarray(jax.jit(jenc.apply)(p, x)), **TOL)
    z = rng.normal(0, 1, (3, 8)).astype(np.float32)
    jdec = JDec(output_channels=3, latent_dim=8, channels=4, screen_size=screen)
    p = perturbed(jdec.init(jax.random.PRNGKey(1), z), 2)
    dec = AEDecoder(3, 8, 4, screen)
    dec.load_state_dict(module_state_from_jax(p["params"], dec))
    got, want = dec(t(z)).detach().numpy(), np.asarray(jax.jit(jdec.apply)(p, z))
    assert got.shape == want.shape == (3, 3, screen, screen)
    np.testing.assert_allclose(got, want, **TOL)


def test_preprocess_obs_matches_jax():
    from sheeprl_tpu.algos.sac_ae.agent import preprocess_obs as jax_fn
    from sheeprl_tpu_torch.algos.sac_ae.agent import preprocess_obs

    x = np.arange(256, dtype=np.uint8).reshape(4, 1, 8, 8)
    np.testing.assert_array_equal(preprocess_obs(t(x)).numpy(), np.asarray(jax_fn(jnp.asarray(x), bits=5)))


@pytest.mark.parametrize("algo", ["sac", "droq", "sac_ae"])
def test_params_from_jax_carries_the_whole_tree(algo):
    """Every leaf carried (``agent_pair`` loads them strictly), the 0-d ``log_alpha`` and
    the target trees included; the targets are copies: stepping the online critic leaves
    them as they were."""
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.utils.policy import extract_policy_params

    _, params, agent, _, _ = agent_pair(algo)
    assert agent.log_alpha.shape == () and agent.log_alpha.item() == pytest.approx(float(params["log_alpha"]))
    before = {k: v.clone() for k, v in agent.state_dict().items()}
    with torch.no_grad():
        for p in agent.critic.parameters():
            p.add_(1.0)
    for k, v in agent.state_dict().items():
        if "target" in k:
            assert torch.equal(v, before[k]), k
    state = {"params": params_from_jax({"agent": params}, {"agent": agent})["agent"]}
    agent.load_state_dict(extract_policy_params(state, None, algo))
    assert all(torch.equal(v, before[k]) for k, v in agent.state_dict().items())


def test_transition_ring_gathers_the_host_rows():
    """The ring holds what the host buffer holds, row for row, through a wrap and a
    rebuild from the host storage; ``sample_idx`` draws ``sample``'s pairs; with
    ``store_dtype`` bf16 the observation planes come back as float32 at bf16's precision."""
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.data.device_buffer import DeviceTransitionRing

    specs = {"obs": ((3,), np.float32), "next_obs": ((3,), np.float32), "actions": ((2,), np.float32),
             "rewards": ((1,), np.float32), "dones": ((1,), np.float32), "frames": ((1, 2, 2), np.uint8)}
    rng = np.random.default_rng(5)
    for store in (None, torch.bfloat16):
        rb = ReplayBuffer(6, 2, obs_keys=("obs",))
        ring = DeviceTransitionRing(6, 2, specs, torch.device("cpu"), store)
        for _ in range(9):
            row = {k: (rng.integers(0, 256, (1, 2, *s)) if d == np.uint8 else rng.normal(0, 1, (1, 2, *s))).astype(d) for k, (s, d) in specs.items()}
            ring.add_step(row, rb._pos)
            rb.add(row)
        for k, (_, d) in specs.items():
            want = rb._buf[k]
            if store is not None and k in ("obs", "next_obs"):
                assert ring.arrays[k].dtype == torch.bfloat16
                np.testing.assert_allclose(ring.host_rows(k), want, rtol=1e-2, atol=1e-2)
            else:
                np.testing.assert_array_equal(ring.host_rows(k), want)
        rb.seed(7)
        envs, rows = rb.sample_idx(4, 3)
        rb.seed(7)
        sample = rb.sample(4, n_samples=3)
        got = {k: torch.stack([ring.gather(t(e), t(r))[k] for e, r in zip(envs, rows)]) for k in specs}
        for k in specs:
            tol = dict(rtol=1e-2, atol=1e-2) if store is not None and k in ("obs", "next_obs") else dict(rtol=0, atol=0)
            assert got[k].dtype == torch.from_numpy(sample[k]).dtype
            np.testing.assert_allclose(got[k].numpy(), sample[k], **tol)
        rebuilt = DeviceTransitionRing(6, 2, specs, torch.device("cpu"), store)
        rebuilt.load_from_dense(rb._buf)
        for k in specs:
            assert torch.equal(rebuilt.arrays[k], ring.arrays[k]), k
