"""DreamerV3 training of the PyTorch port against the JAX package.

The pieces (the world-model loss, the return moments, ``Ratio``, the optimizers) and a
whole gradient step: both packages build a tiny agent from one config, the JAX
parameters (perturbed with seeded noise, so that no head is zero and no LayerNorm the
identity) are carried into the port, both take one ``train_step`` on the same numpy
batch, and the port is handed the draws JAX makes from its key (Gumbel noise for the
categorical samples, normal noise for a continuous actor). Compared afterwards: every
new parameter of the four modules, the Adam moments of the three optimizers, the return
moments and the step's metrics.

Tolerances. float32 (``mesh.precision=32-true``): parameters atol 2e-6 (an Adam step
moves a parameter by about its learning rate, 4e-5 to 1e-4, so this holds each update
to a few percent; the two packages sum in other orders), moments ``mu``/``nu`` rtol
2e-3 with atol 1e-4 of the tensor's largest magnitude (a gradient entry that is a
difference of large terms keeps only the absolute precision of its tensor), metrics
rtol 1e-4. The same step at ``bf16-mixed`` is in ``test_torch_dv3_bf16.py``.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_dv3_agent import OBS_SPACE, TINY, _jitted_init

T, B, HORIZON = 4, 2, 3
STOCH, DISCRETE = 4, 4
SMALL = [f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}", f"algo.horizon={HORIZON}"]
F32 = dict(params=2e-6, mom_rtol=2e-3, mom_atol_of_max=1e-4, metric_rtol=1e-4)
LOSSES = ("Loss/world_model_loss", "Loss/observation_loss", "Loss/reward_loss", "Loss/state_loss", "Loss/continue_loss")
METRICS = LOSSES + (
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Loss/policy_loss",
    "Loss/value_loss",
    "Grads/world_model",
    "Grads/actor",
    "Grads/critic",
)


def _compose(extra=()):
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.config.core import compose as torch_compose

    overrides = [*TINY, *SMALL, *extra]
    return jax_compose(overrides=overrides), torch_compose(overrides=[*overrides, "device=cpu"])


def _train_overrides(is_continuous: bool, precision: str, cnn: bool, extra=()):
    extra = [*(["env=continuous_dummy"] if is_continuous else []), *extra]
    if not cnn:
        extra.append("algo.cnn_keys.encoder=[]")
    return [*extra, f"mesh.precision={precision}"], (["rgb"] if cnn else []) + ["state"]


def build_port_step(params, is_continuous: bool, precision: str, cnn: bool = True, seed: int = 0, extra=()):
    """The port's agent over the carried JAX ``params``, its train step and config."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_step
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.parallel.context import RunContext, compute_dtype

    overrides, keys = _train_overrides(is_continuous, precision, cnn, extra)
    _, tcfg = _compose(overrides)
    port_ctx = RunContext(torch.device("cpu"), seed, compute_dtype=compute_dtype(precision))
    wm, actor, critic, target, _ = build_agent(port_ctx, (2,), is_continuous, tcfg, OBS_SPACE)
    modules = {"world_model": wm, "actor": actor, "critic": critic, "target_critic": target}
    for name, state in params_from_jax(params, modules).items():
        modules[name].load_state_dict(state)
    step, init = make_train_step(wm, actor, critic, target, tcfg, keys[:-1], ["state"])
    return modules, step, init, tcfg


def build_train_pair(is_continuous: bool, precision: str, cnn: bool = True, seed: int = 0, perturb: float = 0.05, extra=()):
    """The JAX step (jitted) and the port's, over the same carried parameters. Without
    ``cnn`` the agent reads the vector key only (a smaller program to compile); ``extra``
    overrides both configs further."""
    import jax

    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as jax_make_train_step
    from sheeprl_tpu.parallel.mesh import MeshContext, build_mesh

    overrides, keys = _train_overrides(is_continuous, precision, cnn, extra)
    jcfg, _ = _compose(overrides)
    actions_dim = (2,)
    ctx = MeshContext(mesh=build_mesh(devices=jax.devices()[:1]), precision=precision, seed=seed)
    with _jitted_init():
        jwm, jactor, jcritic, params, _ = jax_build_agent(ctx, actions_dim, is_continuous, jcfg, OBS_SPACE)
    params = jax.device_get(params)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree.map(lambda x: (x + rng.normal(0.0, perturb, x.shape)).astype(np.float32), params)
    jstep, jinit = jax_make_train_step(jwm, jactor, jcritic, jcfg, keys[:-1], ["state"], {})
    modules, step, init, tcfg = build_port_step(params, is_continuous, precision, cnn, seed, extra)
    return dict(jstep=jax.jit(jstep, static_argnums=(5,)), jinit=jinit, params=params, modules=modules, step=step, init=init, cfg=tcfg)


def make_batch(seed: int, is_continuous: bool):
    rng = np.random.default_rng(seed)
    if is_continuous:
        actions = rng.uniform(-1, 1, size=(T, B, 2)).astype(np.float32)
    else:
        actions = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=(T, B))]
    return {
        "rgb": rng.integers(0, 256, size=(T, B, 3, 64, 64), dtype=np.uint8),
        "state": rng.normal(0.0, 3.0, size=(T, B, 10)).astype(np.float32),
        "actions": actions,
        "rewards": rng.normal(0.0, 2.0, size=(T, B, 1)).astype(np.float32),
        "terminated": (rng.random((T, B, 1)) < 0.2).astype(np.float32),
        "truncated": np.zeros((T, B, 1), np.float32),
        "is_first": (rng.random((T, B, 1)) < 0.2).astype(np.float32),
    }


def jax_draws(key, is_continuous: bool, actions_dim=(2,), decoupled: bool = False):
    """The noise ``make_train_step`` draws from ``key``, split as it splits it. With the
    decoupled RSSM, ``k_wm`` splits into the posterior's key (one draw over ``[T, B]``)
    and the prior chain's (one key per step)."""
    import jax

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import TrainDraws

    def actor_noise(k, n):
        if is_continuous:
            return (jax.random.normal(k, (n, int(sum(actions_dim)))),)
        ks = jax.random.split(k, len(actions_dim))
        return tuple(jax.random.gumbel(ks[i], (n, d)) for i, d in enumerate(actions_dim))

    k_wm, k_img, k_a0 = jax.random.split(key, 3)
    prior, post = [], []
    if decoupled:
        k_repr, k_scan = jax.random.split(k_wm)
        post = jax.random.gumbel(k_repr, (T, B, STOCH, DISCRETE))
        prior = [jax.random.gumbel(k, (B, STOCH, DISCRETE)) for k in jax.random.split(k_scan, T)]
    for k in [] if decoupled else jax.random.split(k_wm, T):
        k1, k2 = jax.random.split(k)
        prior.append(jax.random.gumbel(k1, (B, STOCH, DISCRETE)))
        post.append(jax.random.gumbel(k2, (B, STOCH, DISCRETE)))
    img_prior, img_actor = [], []
    for k in jax.random.split(k_img, HORIZON):
        k_dyn, k_act = jax.random.split(k)
        img_prior.append(jax.random.gumbel(k_dyn, (T * B, STOCH, DISCRETE)))
        img_actor.append(actor_noise(k_act, T * B))
    t = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    return TrainDraws(
        wm_prior=t(np.stack(prior)),
        wm_post=t(np.stack(post)),
        actor0=tuple(t(a) for a in actor_noise(k_a0, T * B)),
        img_prior=t(np.stack(img_prior)),
        img_actor=tuple(t(np.stack([a[i] for a in img_actor])) for i in range(len(img_actor[0]))),
    )


def _adam_state(state):
    if hasattr(state, "mu") and hasattr(state, "nu"):
        return state
    if isinstance(state, tuple):
        for s in state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def run_pair(pair, is_continuous: bool, seed: int = 3, update_target: bool = True):
    import jax
    import jax.numpy as jnp

    batch = make_batch(seed, is_continuous)
    key = jax.random.PRNGKey(seed)
    jparams = jax.tree.map(jnp.asarray, pair["params"])
    jmoments = {"low": jnp.asarray(0.3), "high": jnp.asarray(1.7)}
    jout = pair["jstep"](jparams, pair["jinit"](jparams), jmoments, {k: jnp.asarray(v) for k, v in batch.items()}, key, update_target)
    decoupled = bool(pair["cfg"].algo.world_model.get("decoupled_rssm", False))
    return jax.device_get(jout), run_port(pair["step"], pair["init"], is_continuous, seed, update_target, decoupled)


def run_port(step, init, is_continuous: bool, seed: int = 3, update_target: bool = True, decoupled: bool = False):
    """The port's step on ``run_pair``'s batch, moments and JAX draws."""
    import jax

    from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments

    batch = make_batch(seed, is_continuous)
    moments = init_moments()
    moments["low"].fill_(0.3)
    moments["high"].fill_(1.7)
    opt = init()
    draws = jax_draws(jax.random.PRNGKey(seed), is_continuous, decoupled=decoupled)
    new_moments, metrics = step(opt, moments, {k: torch.from_numpy(v) for k, v in batch.items()}, update_target, draws=draws)
    return opt, new_moments, metrics


def _param_diffs(pair, jparams):
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax

    ref = params_from_jax(jparams, pair["modules"])
    out = {}
    for name, module in pair["modules"].items():
        for k, v in module.state_dict().items():
            out[f"{name}.{k}"] = (v.float() - ref[name][k].float()).abs().max().item()
    return out


@pytest.fixture(scope="module", params=["discrete", "continuous"])
def f32_run(request):
    """Discrete actor with image and vector keys; continuous actor (the gradient through
    the imagined dynamics) on the vector key."""
    is_continuous = request.param == "continuous"
    pair = build_train_pair(is_continuous, "32-true", cnn=not is_continuous)
    return pair, is_continuous, run_pair(pair, is_continuous)


def test_train_step_f32_new_parameters_match_jax(f32_run):
    pair, _, (jout, _) = f32_run
    diffs = _param_diffs(pair, jout[0])
    worst = max(diffs, key=diffs.get)
    assert diffs[worst] <= F32["params"], (worst, diffs[worst])


def test_train_step_f32_optimizer_moments_match_jax(f32_run):
    from sheeprl_tpu_torch.algos.dreamer_v3.params import parameter_list_from_jax

    pair, _, (jout, (opt, _, _)) = f32_run
    for name in ("world_model", "actor", "critic"):
        ref = _adam_state(jout[1][name])
        assert opt[name]["count"] == int(ref.count) == 1
        for moment in ("mu", "nu"):
            want = parameter_list_from_jax(getattr(ref, moment), pair["modules"][name], name)
            for got, exp in zip(opt[name][moment], want):
                atol = F32["mom_atol_of_max"] * exp.abs().max().item()
                torch.testing.assert_close(got, exp, rtol=F32["mom_rtol"], atol=atol, msg=lambda m: f"{name}.{moment}: {m}")


def test_train_step_f32_moments_and_metrics_match_jax(f32_run):
    _, _, (jout, (_, moments, metrics)) = f32_run
    for k in ("low", "high"):
        np.testing.assert_allclose(moments[k].item(), float(jout[2][k]), rtol=1e-5, atol=1e-7)
    for name in METRICS:
        np.testing.assert_allclose(metrics[name].item(), float(jout[3][name]), rtol=F32["metric_rtol"], atol=1e-7, err_msg=name)


def test_train_step_f32_health_matches_jax(f32_run):
    """The step's ``Health/*`` diagnostics (on by default in both packages): the same
    names, the values at the metrics' tolerance."""
    _, _, (jout, (_, _, metrics)) = f32_run
    health = sorted(k for k in jout[3] if k.startswith("Health/"))
    assert health and health == sorted(k for k in metrics if k.startswith("Health/"))
    for name in health:
        np.testing.assert_allclose(metrics[name].item(), float(jout[3][name]), rtol=F32["metric_rtol"], atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------------------


def test_reconstruction_loss_matches_jax():
    import jax.numpy as jnp

    from sheeprl_tpu.algos.dreamer_v3.loss import reconstruction_loss as jax_loss
    from sheeprl_tpu_torch.algos.dreamer_v3.loss import reconstruction_loss

    rng = np.random.default_rng(0)
    args = [
        rng.normal(-50, 5, size=(T, B)).astype(np.float32),
        rng.normal(-2, 1, size=(T, B)).astype(np.float32),
        rng.normal(size=(T, B, STOCH, DISCRETE)).astype(np.float32),
        rng.normal(size=(T, B, STOCH, DISCRETE)).astype(np.float32),
    ]
    cont = rng.normal(-1, 0.3, size=(T, B)).astype(np.float32)
    for kw in (dict(), dict(kl_free_nats=0.1, kl_dynamic=0.4, kl_regularizer=2.0, continue_scale_factor=0.5)):
        jl, jm = jax_loss(*(jnp.asarray(a) for a in args), continue_log_prob=jnp.asarray(cont), **kw)
        tl, tm = reconstruction_loss(*(torch.from_numpy(a) for a in args), continue_log_prob=torch.from_numpy(cont), **kw)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_update_moments_matches_jax():
    import jax.numpy as jnp

    from sheeprl_tpu.algos.dreamer_v3.utils import update_moments as jax_update
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import update_moments

    rng = np.random.default_rng(1)
    jstate = {"low": jnp.asarray(0.0), "high": jnp.asarray(0.0)}
    tstate = {"low": torch.tensor(0.0), "high": torch.tensor(0.0)}
    for step in range(3):
        x = rng.normal(step, 3, size=(HORIZON, 37, 1)).astype(np.float32)
        jo, ji, jstate = jax_update(jstate, jnp.asarray(x), decay=0.9, max_=1.0, percentile_low=0.05, percentile_high=0.95)
        to, ti, tstate = update_moments(tstate, torch.from_numpy(x), decay=0.9, max_=1.0, percentile_low=0.05, percentile_high=0.95)
        np.testing.assert_allclose([to.item(), ti.item()], [float(jo), float(ji)], rtol=1e-6)


def test_ratio_matches_jax_and_round_trips():
    from sheeprl_tpu.utils.utils import Ratio as JaxRatio
    from sheeprl_tpu_torch.utils.utils import Ratio

    for ratio, pretrain in ((0.5, 0), (1.0, 0), (0.0625, 0), (1.0, 16)):
        j, t = JaxRatio(ratio, pretrain), Ratio(ratio, pretrain)
        steps = [8, 10, 12, 13, 40, 41, 100]
        assert [t(s) for s in steps] == [j(s) for s in steps]
        t2 = Ratio(0.1).load_state_dict(t.state_dict())
        assert t2.state_dict() == t.state_dict() == j.state_dict()
        assert t2(150) == j(150)


OPT_CASES = {
    "adam": dict(name="adam", lr=1e-2, eps=1e-5, betas=[0.9, 0.999], weight_decay=0.0),
    "adam_l2": dict(name="adam", lr=1e-2, eps=1e-8, betas=[0.8, 0.999], weight_decay=0.1),
    "adamw": dict(name="adamw", lr=1e-2, eps=1e-8, weight_decay=0.05),
    "sgd": dict(name="sgd", lr=1e-2, momentum=0.9),
    "rmsprop_tf": dict(name="rmsprop_tf", lr=1e-2, alpha=0.9, eps=1e-4, momentum=0.5),
    "rmsprop_tf_centered": dict(name="rmsprop_tf", lr=1e-2, alpha=0.9, eps=1e-4, centered=True, momentum=0.0),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_optimizer_matches_optax(case, clip):
    """Four updates of three tensors with seeded gradients; ``clip=0.5`` clips every
    update (the gradients' global norm is ~10)."""
    import jax.numpy as jnp
    import optax

    from sheeprl_tpu.algos.ppo.ppo import make_optimizer as jax_make_optimizer
    from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer

    rng = np.random.default_rng(2)
    shapes = [(4, 3), (3,), (2, 2, 5)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(4)]
    jopt = jax_make_optimizer(OPT_CASES[case], clip)
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)
    topt = make_optimizer(OPT_CASES[case], clip)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    tstate = topt.init(tparams)
    for g in grads:
        updates, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = topt.update(tparams, [torch.from_numpy(x) for x in g], tstate)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm([jnp.asarray(x) for x in g])), rtol=1e-6)
    for t, j in zip(tparams, jparams):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-6)


def test_update_target_cadence_matches_train_block():
    """The loop's target-critic flags over blocks of gradient steps equal the flags the
    reference's ``make_train_block`` hands its step function."""
    import jax.numpy as jnp

    from sheeprl_tpu.utils.blocks import make_train_block
    from sheeprl_tpu_torch.utils.blocks import target_flags

    def step_fn(carry, batch, key, update_target):
        i, flags = carry
        return (i + 1, flags.at[i].set(update_target)), {}

    for freq in (1, 2, 3):
        block = make_train_block(step_fn, freq, 1)
        count = 0
        for n in (1, 3, 2, 4):
            carry = (jnp.asarray(0), jnp.zeros(n, bool))
            (_, flags), _ = block(carry, [jnp.zeros(1)] * n, jax_key(0), count)
            assert target_flags(count, n, freq).tolist() == [bool(f) for f in np.asarray(flags)], (freq, count, n)
            count += n


def jax_key(seed):
    import jax

    return jax.random.PRNGKey(seed)
