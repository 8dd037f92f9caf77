"""DreamerV1 training of the PyTorch port against the JAX package.

A whole gradient step: both packages build a tiny agent from the ``dreamer_v1_dummy``
exp, the JAX parameters (perturbed with seeded noise) are carried into the port, both
take one ``train_step`` on the same numpy batch, and the port is handed the noise JAX
draws from its key. Two cases: a discrete actor over the image and vector keys at the
exp's defaults (free nats 3, which this batch's KL of ~3.9 exceeds), and a continuous
actor (``trunc_normal``) over the vector key with the continue head on and
``kl_free_nats=0``; in both the KL's gradient reaches the world model. Compared afterwards: every new parameter of the three modules,
the Adam moments of the three optimizers, the losses and the gradient norms, at the
limits of ``test_torch_dv2_train.py``. Then the pieces: ``normal_kl``,
``reconstruction_loss`` and ``compute_lambda_values``.

The bf16-mixed step is held to the JAX package's bf16 step as ``test_torch_dv2_bf16.py``
holds DreamerV2's (see there), at its limits: the parameter changes off JAX's by more
than 0.1 of the lr on at most ``MAX_OFF_SHARE`` of a module's entries, each leaf's Adam
``mu`` within ``MU_RTOL`` and ``nu`` within ``NU_RTOL`` by relative norm, the losses and
gradient norms within ``METRIC_RTOL``. The conv biases the reference sums in bf16
(``SUMMED_IN_BF16``) are held to JAX's float32 step instead, with the world model's clip
lifted in all three steps, at their own limits ``SUMMED_MU_RTOL`` and ``SUMMED_NU_RTOL``:
the first transposed conv's bias gradient, a sum over the map whose terms largely
cancel, came out 0.136 (``mu``) and 0.243 (``nu``) off JAX's float32 step at seed 1,
where JAX's own bf16 step lies 0.66-0.93 off it. The other readings (``python -m tests.torch_dv1_bf16_readings``,
seeds 0-2, both actors, on the CPU): off shares at most 2.9 % (the continuous actor),
``mu`` at most 0.044 and ``nu`` 0.072 on the other leaves, the metrics at most 8.9e-3
(``Grads/critic``).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_dv1_agent import ACTIONS_DIM, jax_ctx, jitted_init
from tests.test_torch_dv2_agent import perturbed
from tests.test_torch_dv2_bf16 import MAX_OFF_SHARE, METRIC_RTOL, MU_RTOL, NU_RTOL, STEP_ATOL_OF_LR, SUMMED_IN_BF16
from tests.test_torch_dv2_train import make_batch
from tests.test_torch_dv3_agent import OBS_SPACE
from tests.test_torch_dv3_train import F32, _adam_state

T, B, HORIZON = 4, 2, 3
STOCH = 4
BASE = ["exp=dreamer_v1_dummy", "env=discrete_dummy", f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}", f"algo.horizon={HORIZON}"]
CASES = {
    "discrete": dict(overrides=[], keys=(["rgb"], ["state"])),
    "continuous": dict(
        overrides=["env=continuous_dummy", "algo.cnn_keys.encoder=[]", "algo.world_model.use_continues=True", "algo.world_model.kl_free_nats=0"],
        keys=([], ["state"]),
    ),
}
LOSSES = ("Loss/world_model_loss", "Loss/observation_loss", "Loss/reward_loss", "Loss/state_loss", "Loss/continue_loss")
METRICS = LOSSES + ("State/kl", "State/post_entropy", "State/prior_entropy", "Loss/policy_loss", "Loss/value_loss")
GRADS = ("Grads/world_model", "Grads/actor", "Grads/critic")
MODULES = ("world_model", "actor", "critic")
UNCLIPPED = {"discrete": ["algo.world_model.clip_gradients=1e9"], "continuous": []}
SUMMED_MU_RTOL, SUMMED_NU_RTOL = 0.3, 0.5


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def compose(kind: str, precision: str, extra=()):
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.config.core import compose as torch_compose

    overrides = [*BASE, *CASES[kind]["overrides"], f"mesh.precision={precision}", *extra]
    return jax_compose(overrides=overrides), torch_compose(overrides=[*overrides, "device=cpu"])


def build_train_pair(kind: str, precision: str, seed: int = 0, perturb: float = 0.05, extra=()):
    """The JAX step (jitted) and the port's, over the same carried parameters."""
    import jax

    from sheeprl_tpu.algos.dreamer_v1 import agent as jax_agent
    from sheeprl_tpu.algos.dreamer_v1.dreamer_v1 import make_train_step as jax_make_train_step
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import make_train_step
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.parallel.context import RunContext, compute_dtype

    jcfg, tcfg = compose(kind, precision, extra)
    continuous = kind == "continuous"
    with jitted_init(jax_agent):
        jwm, jactor, jcritic, params, _ = jax_agent.build_agent(jax_ctx(precision, seed), ACTIONS_DIM, continuous, jcfg, OBS_SPACE)
    jstep, jinit = jax_make_train_step(jwm, jactor, jcritic, jcfg, *CASES[kind]["keys"])
    params = perturbed(params, seed + 100, perturb)
    ctx = RunContext(torch.device("cpu"), seed, compute_dtype=compute_dtype(precision))
    modules = dict(zip(MODULES, build_agent(ctx, ACTIONS_DIM, continuous, tcfg, OBS_SPACE)[:3]))
    for name, state in params_from_jax(params, modules).items():
        modules[name].load_state_dict(state)
    step, init = make_train_step(*modules.values(), tcfg, *CASES[kind]["keys"])
    return dict(jstep=jax.jit(jstep), jinit=jinit, params=params, modules=modules, step=step, init=init, cfg=tcfg)


def actor_draws(k_act, rows: int, is_continuous: bool):
    """The noise JAX's ``ActorV2`` draws from ``k_act`` for ``rows`` latents: the truncated
    normal's uniform noise, or Gumbel noise per discrete head."""
    import jax

    if is_continuous:
        return (jax.random.uniform(k_act, (rows, 2), minval=1e-5, maxval=1 - 1e-5),)
    return tuple(jax.random.gumbel(kh, (rows, d)) for kh, d in zip(jax.random.split(k_act, len(ACTIONS_DIM)), ACTIONS_DIM))


def imagination_draws(k_img, is_continuous: bool, prior_shape):
    """Per imagined step, ``k_act, k_dyn = split(k)``: the actor's noise and the prior's."""
    import jax

    acts, priors = [], []
    for k in jax.random.split(k_img, HORIZON):
        k_act, k_dyn = jax.random.split(k)
        acts.append(actor_draws(k_act, T * B, is_continuous))
        priors.append(jax.random.normal(k_dyn, prior_shape) if len(prior_shape) == 2 else jax.random.gumbel(k_dyn, prior_shape))
    return tuple(np.stack([a[i] for a in acts]) for i in range(len(acts[0]))), np.stack(priors)


def unroll_draws(k_wm, stoch_shape, kind: str = "normal"):
    """Per unroll step, ``k1, k2 = split(k)``: the prior's and the posterior's noise."""
    import jax

    draw = jax.random.normal if kind == "normal" else jax.random.gumbel
    prior, post = [], []
    for k in jax.random.split(k_wm, T):
        k1, k2 = jax.random.split(k)
        prior.append(draw(k1, (B, *stoch_shape)))
        post.append(draw(k2, (B, *stoch_shape)))
    return np.stack(prior), np.stack(post)


def to_t(x):
    return tuple(to_t(v) for v in x) if isinstance(x, tuple) else torch.from_numpy(np.array(x, np.float32))


def jax_draws(key, is_continuous: bool):
    """The noise the reference's DreamerV1 step draws from ``key``, split as it splits it."""
    import jax

    from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import TrainDraws

    k_wm, k_img, _ = jax.random.split(key, 3)
    prior, post = unroll_draws(k_wm, (STOCH,))
    img_actor, img_prior = imagination_draws(k_img, is_continuous, (T * B, STOCH))
    return TrainDraws(*to_t((prior, post, img_actor, img_prior)))


def run_pair(pair, kind: str, seed: int = 3):
    """One step of each package from the carried parameters on the batch and key of
    ``seed``: ``((params, opt_states, metrics) of JAX as numpy, (opt_states, metrics) of
    the port)``."""
    import jax
    import jax.numpy as jnp

    continuous = kind == "continuous"
    batch = make_batch(seed, continuous)
    jparams = jax.tree.map(jnp.asarray, pair["params"])
    jout = jax.device_get(pair["jstep"](jparams, pair["jinit"](jparams), {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(seed)))
    opt = pair["init"]()
    _, metrics = pair["step"](opt, {}, {k: torch.from_numpy(v) for k, v in batch.items()}, False, draws=jax_draws(jax.random.PRNGKey(seed), continuous))
    return jout, (opt, metrics)


def assert_params_match(modules, jparams, atol):
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax

    ref = params_from_jax(jparams, modules)
    diffs = {f"{n}.{k}": (v.float() - ref[n][k]).abs().max().item() for n, m in modules.items() for k, v in m.state_dict().items()}
    worst = max(diffs, key=diffs.get)
    assert diffs[worst] <= atol, (worst, diffs[worst])


def assert_moments_match(opt, jopt, modules, names):
    """``opt[name]`` against optax's state ``jopt[name]`` for each of ``names``
    (``{opt name: module name}``): the count, ``mu`` and ``nu`` at ``F32``'s limits."""
    from sheeprl_tpu_torch.algos.dreamer_v3.params import parameter_list_from_jax

    for name, module in names.items():
        ref = _adam_state(jopt[name])
        assert opt[name]["count"] == int(ref.count) == 1
        for moment in ("mu", "nu"):
            want = parameter_list_from_jax(getattr(ref, moment), modules[module], name)
            for got, exp in zip(opt[name][moment], want):
                atol = F32["mom_atol_of_max"] * exp.abs().max().item()
                torch.testing.assert_close(got, exp, rtol=F32["mom_rtol"], atol=atol, msg=lambda m: f"{name}.{moment}: {m}")


@pytest.fixture(scope="module", params=sorted(CASES))
def f32_run(request):
    pair = build_train_pair(request.param, "32-true")
    return {**pair, "kind": request.param}, run_pair(pair, request.param)


def test_train_step_f32_new_parameters_match_jax(f32_run):
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax

    pair, (jout, _) = f32_run
    assert_params_match(pair["modules"], jout[0], F32["params"])
    old = params_from_jax(pair["params"], pair["modules"])
    for name, module in pair["modules"].items():
        assert any(not torch.equal(v, old[name][k]) for k, v in module.state_dict().items()), name


def test_train_step_f32_optimizer_moments_match_jax(f32_run):
    pair, (jout, (opt, _)) = f32_run
    assert_moments_match(opt, jout[1], pair["modules"], {n: n for n in MODULES})


def test_train_step_f32_losses_and_gradient_norms_match_jax(f32_run):
    pair, (jout, (_, metrics)) = f32_run
    for name in METRICS + GRADS:
        np.testing.assert_allclose(metrics[name].item(), float(jout[2][name]), rtol=F32["metric_rtol"], atol=1e-7, err_msg=name)
    # the state loss is the KL clipped below at the free nats
    kl, state = metrics["State/kl"].item(), metrics["Loss/state_loss"].item()
    assert state == max(kl, pair["cfg"].algo.world_model.kl_free_nats)
    if pair["kind"] == "continuous":
        assert metrics["Loss/continue_loss"].item() > 0


def test_normal_kl_and_reconstruction_loss_match_jax():
    import jax.numpy as jnp

    from sheeprl_tpu.algos.dreamer_v1.loss import normal_kl as jax_kl
    from sheeprl_tpu.algos.dreamer_v1.loss import reconstruction_loss as jax_loss
    from sheeprl_tpu_torch.algos.dreamer_v1.loss import normal_kl, reconstruction_loss

    rng = np.random.default_rng(0)
    obs_lp = rng.normal(-50, 5, size=(T, B)).astype(np.float32)
    rew_lp = rng.normal(-2, 1, size=(T, B)).astype(np.float32)
    ms = [rng.normal(size=(T, B, STOCH)).astype(np.float32) if i % 2 == 0 else rng.uniform(0.1, 2, size=(T, B, STOCH)).astype(np.float32) for i in range(4)]
    np.testing.assert_allclose(normal_kl(*(torch.from_numpy(a) for a in ms)).numpy(), np.asarray(jax_kl(*ms)), rtol=1e-6, atol=1e-6)
    cont = rng.normal(-1, 0.3, size=(T, B)).astype(np.float32)
    for kw in (dict(), dict(kl_free_nats=0.0), dict(kl_free_nats=1.0, kl_regularizer=2.0, continue_scale_factor=0.5)):
        for c in (None, cont):
            jl, jm = jax_loss(
                jnp.asarray(obs_lp), jnp.asarray(rew_lp), (jnp.asarray(ms[0]), jnp.asarray(ms[1])), (jnp.asarray(ms[2]), jnp.asarray(ms[3])),
                continue_lp=None if c is None else jnp.asarray(c), **kw,
            )
            tl, tm = reconstruction_loss(
                torch.from_numpy(obs_lp), torch.from_numpy(rew_lp), (torch.from_numpy(ms[0]), torch.from_numpy(ms[1])),
                (torch.from_numpy(ms[2]), torch.from_numpy(ms[3])), continue_lp=None if c is None else torch.from_numpy(c), **kw,
            )
            np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
            for k in jm:
                np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_compute_lambda_values_matches_jax():
    from sheeprl_tpu.algos.dreamer_v1.utils import compute_lambda_values as jax_lambda
    from sheeprl_tpu_torch.algos.dreamer_v1.utils import compute_lambda_values

    rng = np.random.default_rng(1)
    h, n = 5, 7
    rewards, values = (rng.normal(size=(h, n, 1)).astype(np.float32) for _ in range(2))
    continues = (0.99 * (rng.random((h, n, 1)) > 0.1)).astype(np.float32)
    for lmbda in (0.95, 0.0, 1.0):
        ref = jax_lambda(rewards, values, continues, lmbda)
        out = compute_lambda_values(*(torch.from_numpy(a) for a in (rewards, values, continues)), lmbda)
        assert out.shape == (h - 1, n, 1)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------------------
# bf16-mixed against the JAX package's bf16 step
# ---------------------------------------------------------------------------------------


def train_step_readings(kind: str, seed: int = 0) -> dict:
    """One whole step at bf16-mixed in both packages and what the test compares, as
    ``test_torch_dv2_bf16.py::train_step_readings`` reads DreamerV2's."""
    import jax
    import jax.numpy as jnp

    from sheeprl_tpu_torch.algos.dreamer_v3.params import parameter_list_from_jax, params_from_jax

    pair = build_train_pair(kind, "bf16-mixed", seed=seed, extra=UNCLIPPED[kind])
    modules = pair["modules"]
    assert modules["world_model"].rssm.recurrent_model.rnn.hr.compute_dtype == torch.bfloat16
    old = params_from_jax(pair["params"], modules)
    jout, (opt, metrics) = run_pair(pair, kind, seed=seed + 3)
    new_jax = params_from_jax(jout[0], modules)
    algo = pair["cfg"].algo
    lr = {"world_model": algo.world_model.optimizer.lr, "actor": algo.actor.optimizer.lr, "critic": algo.critic.optimizer.lr}
    out = {"off_share": {}, "mu": {}, "nu": {}, "metrics": {}, "jax_off_f32": {}}
    for name, module in modules.items():
        off = torch.cat([
            ((v.float() - old[name][k]) - (new_jax[name][k] - old[name][k])).abs().flatten() > STEP_ATOL_OF_LR * lr[name]
            for k, v in module.state_dict().items()
        ])
        out["off_share"][name] = off.float().mean().item()
    f32 = None
    if any(f"{name}.{k}" in SUMMED_IN_BF16 for name, m in modules.items() for k, _ in m.named_parameters()):
        pair32 = build_train_pair(kind, "32-true", seed=seed, extra=UNCLIPPED[kind])
        jparams = jax.tree.map(jnp.asarray, pair["params"])
        batch = {k: jnp.asarray(v) for k, v in make_batch(seed + 3, kind == "continuous").items()}
        f32 = jax.device_get(pair32["jstep"](jparams, pair32["jinit"](jparams), batch, jax.random.PRNGKey(seed + 3)))
    for name in MODULES:
        ref = _adam_state(jout[1][name])
        leaves = [k for k, _ in modules[name].named_parameters()]
        for moment in ("mu", "nu"):
            want = parameter_list_from_jax(getattr(ref, moment), modules[name], name)
            want32 = want if f32 is None else parameter_list_from_jax(getattr(_adam_state(f32[1][name]), moment), modules[name], name)
            for leaf, got, exp, exp32 in zip(leaves, opt[name][moment], want, want32):
                if f"{name}.{leaf}" in SUMMED_IN_BF16:
                    out["jax_off_f32"][f"{name}.{leaf}.{moment}"] = ((exp - exp32).norm() / exp32.norm()).item()
                    exp = exp32
                err, norm = (got - exp).norm().item(), exp.norm().item()
                out[moment][f"{name}.{leaf}"] = err / norm if norm > 0 else (0.0 if err == 0 else float("inf"))
    for name in (*LOSSES, *GRADS):
        ref = float(f32[2][name]) if name == "Grads/world_model" and f32 is not None else float(jout[2][name])
        out["metrics"][name] = abs(metrics[name].item() - ref) / max(abs(ref), 1e-6)
    out["finite"] = all(np.isfinite(metrics[name].item()) for name in METRICS + GRADS)
    return out


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_train_step_bf16_matches_jax_bf16(kind):
    readings = train_step_readings(kind)
    for name, share in readings["off_share"].items():
        assert share <= MAX_OFF_SHARE, (name, share)
    for moment, rtol, summed_rtol in (("mu", MU_RTOL, SUMMED_MU_RTOL), ("nu", NU_RTOL, SUMMED_NU_RTOL)):
        for leaf, rel in readings[moment].items():
            assert rel <= (summed_rtol if leaf in SUMMED_IN_BF16 else rtol), (leaf, moment, rel)
    for name, rel in readings["metrics"].items():
        assert rel <= METRIC_RTOL, (name, rel)
    assert readings["finite"]
