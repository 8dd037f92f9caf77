"""DreamerV2 training of the PyTorch port against the JAX package.

A whole gradient step: both packages build a tiny agent from the ``dreamer_v2_dummy``
exp, the JAX parameters (perturbed with seeded noise, so that the target critic differs
from the critic and no LayerNorm is the identity) are carried into the port, both take
one ``train_step`` on the same numpy batch, and the port is handed the draws JAX makes
from its key. Two cases: a discrete actor over the image and vector keys at the exp's
defaults, with the target copy; a continuous actor (``trunc_normal``) over the vector
key with the continue head on, ``objective_mix=0.5`` (the dynamics gradient through the
imagination counts), the per-element free nats and no target copy. Compared afterwards:
every new parameter of the four modules, the Adam moments of the three optimizers, the
losses and the gradient norms. Then the pieces on their own: ``categorical_kl``,
``reconstruction_loss``, ``compute_lambda_values`` and the target copy's cadence.

Tolerances (float32, ``mesh.precision=32-true``), as the DreamerV3 step's
(``test_torch_dv3_train.py``): parameters atol 2e-6 (an Adam step moves a parameter by
about its learning rate, 8e-5 to 3e-4), moments ``mu``/``nu`` rtol 2e-3 with atol 1e-4 of
the tensor's largest magnitude, metrics rtol 1e-4. The bf16-mixed step is in
``test_torch_dv2_bf16.py``.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_dv2_agent import ACTIONS_DIM, jitted_init, perturbed
from tests.test_torch_dv3_agent import OBS_SPACE
from tests.test_torch_dv3_train import F32, _adam_state

T, B, HORIZON = 4, 2, 3
STOCH, DISCRETE = 4, 4
BASE = ["exp=dreamer_v2_dummy", "env=discrete_dummy", f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}", f"algo.horizon={HORIZON}"]
CASES = {
    "discrete": dict(overrides=[], keys=(["rgb"], ["state"]), update_target=True),
    "continuous": dict(
        overrides=[
            "env=continuous_dummy",
            "algo.cnn_keys.encoder=[]",
            "algo.world_model.use_continues=True",
            "algo.actor.objective_mix=0.5",
            "algo.world_model.kl_free_avg=False",
        ],
        keys=([], ["state"]),
        update_target=False,
    ),
}
LOSSES = ("Loss/world_model_loss", "Loss/observation_loss", "Loss/reward_loss", "Loss/state_loss", "Loss/continue_loss")
METRICS = LOSSES + ("State/kl", "State/post_entropy", "State/prior_entropy", "Loss/policy_loss", "Loss/value_loss")
GRADS = ("Grads/world_model", "Grads/actor", "Grads/critic")
MODULES = ("world_model", "actor", "critic", "target_critic")


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


def build_port_step(params, kind: str, precision: str, seed: int = 0, extra=()):
    """The port's agent over the carried JAX ``params`` and its train step."""
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import make_train_step
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.parallel.context import RunContext, compute_dtype

    _, tcfg = compose(kind, precision, extra)
    ctx = RunContext(torch.device("cpu"), seed, compute_dtype=compute_dtype(precision))
    wm, actor, critic, target, _ = build_agent(ctx, ACTIONS_DIM, kind == "continuous", tcfg, OBS_SPACE)
    modules = dict(zip(MODULES, (wm, actor, critic, target)))
    for name, state in params_from_jax(params, modules).items():
        modules[name].load_state_dict(state)
    step, init = make_train_step(wm, actor, critic, target, tcfg, *CASES[kind]["keys"])
    return modules, step, init, tcfg


def build_jax_step(kind: str, precision: str, seed: int = 0, extra=()):
    """The JAX package's train step (jitted), its optimizer init and the agent's initial
    parameters; ``extra`` overrides the case's config."""
    import jax

    from sheeprl_tpu.algos.dreamer_v2.agent import build_agent as jax_build_agent
    from sheeprl_tpu.algos.dreamer_v2.dreamer_v2 import make_train_step as jax_make_train_step
    from sheeprl_tpu.parallel.mesh import MeshContext, build_mesh

    jcfg, _ = compose(kind, precision, extra)
    ctx = MeshContext(mesh=build_mesh(devices=jax.devices()[:1]), precision=precision, seed=seed)
    with jitted_init():
        jwm, jactor, jcritic, params, _ = jax_build_agent(ctx, ACTIONS_DIM, kind == "continuous", jcfg, OBS_SPACE)
    jstep, jinit = jax_make_train_step(jwm, jactor, jcritic, jcfg, *CASES[kind]["keys"])
    return jax.jit(jstep), jinit, params


def build_train_pair(kind: str, precision: str, seed: int = 0, perturb: float = 0.05, extra=()):
    """The JAX step (jitted) and the port's, over the same carried parameters; ``extra``
    overrides the case's config."""
    jstep, jinit, params = build_jax_step(kind, precision, seed, extra)
    params = perturbed(params, seed + 100, perturb)
    modules, step, init, tcfg = build_port_step(params, kind, precision, seed, extra)
    return dict(jstep=jstep, jinit=jinit, params=params, modules=modules, step=step, init=init, cfg=tcfg)


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


def jax_draws(key, is_continuous: bool):
    """The noise the reference's ``make_train_step`` draws from ``key``, split as it
    splits it: the unroll's prior and posterior Gumbel noise, then per imagined step the
    actor's noise (``k_act``: Gumbel per head, or the truncated normal's uniform) and the
    prior's Gumbel noise (``k_dyn``)."""
    import jax

    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import TrainDraws

    k_wm, k_img, _ = jax.random.split(key, 3)
    prior, post = [], []
    for k in jax.random.split(k_wm, T):
        k1, k2 = jax.random.split(k)
        prior.append(jax.random.gumbel(k1, (B, STOCH, DISCRETE)))
        post.append(jax.random.gumbel(k2, (B, STOCH, DISCRETE)))
    img_prior, img_actor = [], []
    for k in jax.random.split(k_img, HORIZON):
        k_act, k_dyn = jax.random.split(k)
        if is_continuous:
            img_actor.append((jax.random.uniform(k_act, (T * B, 2), minval=1e-5, maxval=1 - 1e-5),))
        else:
            img_actor.append(tuple(jax.random.gumbel(kh, (T * B, d)) for kh, d in zip(jax.random.split(k_act, 1), ACTIONS_DIM)))
        img_prior.append(jax.random.gumbel(k_dyn, (T * B, STOCH, DISCRETE)))
    t = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    return TrainDraws(
        wm_prior=t(np.stack(prior)),
        wm_post=t(np.stack(post)),
        img_actor=tuple(t(np.stack([a[i] for a in img_actor])) for i in range(len(img_actor[0]))),
        img_prior=t(np.stack(img_prior)),
    )


def run_port(step, init, kind: str, seed: int):
    import jax

    opt = init()
    batch = {k: torch.from_numpy(v) for k, v in make_batch(seed, kind == "continuous").items()}
    _, metrics = step(opt, step.init_extra(), batch, CASES[kind]["update_target"], draws=jax_draws(jax.random.PRNGKey(seed), kind == "continuous"))
    return opt, metrics


def run_jax(jstep, jinit, params, kind: str, seed: int):
    """One JAX step from ``params`` on the batch and key of ``seed``: ``(params,
    opt_states, metrics)`` as numpy."""
    import jax
    import jax.numpy as jnp

    batch = {k: jnp.asarray(v) for k, v in make_batch(seed, kind == "continuous").items()}
    jparams = jax.tree.map(jnp.asarray, params)
    return jax.device_get(jstep(jparams, jinit(jparams), batch, jax.random.PRNGKey(seed), jnp.asarray(CASES[kind]["update_target"])))


def run_pair(pair, kind: str, seed: int = 3):
    return run_jax(pair["jstep"], pair["jinit"], pair["params"], kind, seed), run_port(pair["step"], pair["init"], kind, seed)


@pytest.fixture(scope="module", params=sorted(CASES))
def f32_run(request):
    pair = build_train_pair(request.param, "32-true")
    return {**pair, "kind": request.param}, run_pair(pair, request.param)


def test_train_step_f32_new_parameters_match_jax(f32_run):
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax

    pair, (jout, _) = f32_run
    ref = params_from_jax(jout[0], pair["modules"])
    diffs = {
        f"{name}.{k}": (v.float() - ref[name][k]).abs().max().item()
        for name, module in pair["modules"].items()
        for k, v in module.state_dict().items()
    }
    worst = max(diffs, key=diffs.get)
    assert diffs[worst] <= F32["params"], (worst, diffs[worst])
    # each module moved, the target critic only where the flag copies the critic in
    old = params_from_jax(pair["params"], pair["modules"])
    for name, module in pair["modules"].items():
        moved = any(not torch.equal(v, old[name][k]) for k, v in module.state_dict().items())
        assert moved == (name != "target_critic" or CASES[pair["kind"]]["update_target"]), name


def test_train_step_f32_optimizer_moments_match_jax(f32_run):
    from sheeprl_tpu_torch.algos.dreamer_v3.params import parameter_list_from_jax

    pair, (jout, (opt, _)) = f32_run
    for name in ("world_model", "actor", "critic"):
        ref = _adam_state(jout[1][name])
        assert opt[name]["count"] == int(ref.count) == 1
        for moment in ("mu", "nu"):
            want = parameter_list_from_jax(getattr(ref, moment), pair["modules"][name], name)
            for got, exp in zip(opt[name][moment], want):
                atol = F32["mom_atol_of_max"] * exp.abs().max().item()
                torch.testing.assert_close(got, exp, rtol=F32["mom_rtol"], atol=atol, msg=lambda m: f"{name}.{moment}: {m}")


def test_train_step_f32_losses_and_gradient_norms_match_jax(f32_run):
    _, (jout, (_, metrics)) = f32_run
    for name in METRICS + GRADS:
        np.testing.assert_allclose(metrics[name].item(), float(jout[2][name]), rtol=F32["metric_rtol"], atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------------------


def test_categorical_kl_and_reconstruction_loss_match_jax():
    import jax.numpy as jnp

    from sheeprl_tpu.algos.dreamer_v2.loss import categorical_kl as jax_kl
    from sheeprl_tpu.algos.dreamer_v2.loss import reconstruction_loss as jax_loss
    from sheeprl_tpu_torch.algos.dreamer_v2.loss import categorical_kl, reconstruction_loss

    rng = np.random.default_rng(0)
    args = [
        rng.normal(-50, 5, size=(T, B)).astype(np.float32),
        rng.normal(-2, 1, size=(T, B)).astype(np.float32),
        rng.normal(size=(T, B, STOCH, DISCRETE)).astype(np.float32),
        rng.normal(size=(T, B, STOCH, DISCRETE)).astype(np.float32),
    ]
    np.testing.assert_allclose(
        categorical_kl(torch.from_numpy(args[3]), torch.from_numpy(args[2])).numpy(), np.asarray(jax_kl(args[3], args[2])), rtol=1e-6, atol=1e-7
    )
    cont = rng.normal(-1, 0.3, size=(T, B)).astype(np.float32)
    for kw in (
        dict(),
        dict(kl_free_nats=1.0),
        dict(kl_free_nats=0.6, kl_free_avg=False, kl_balancing_alpha=0.6, kl_regularizer=2.0, discount_scale_factor=0.5),
    ):
        for c in (None, cont):
            jl, jm = jax_loss(*(jnp.asarray(a) for a in args), continue_lp=None if c is None else jnp.asarray(c), **kw)
            tl, tm = reconstruction_loss(*(torch.from_numpy(a) for a in args), continue_lp=None if c is None else torch.from_numpy(c), **kw)
            np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
            for k in jm:
                np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_compute_lambda_values_matches_jax():
    from sheeprl_tpu.algos.dreamer_v2.utils import compute_lambda_values as jax_lambda
    from sheeprl_tpu_torch.algos.dreamer_v2.utils import compute_lambda_values

    rng = np.random.default_rng(1)
    h, n = 5, 7
    rewards, values = (rng.normal(size=(h, n, 1)).astype(np.float32) for _ in range(2))
    continues = (0.99 * (rng.random((h, n, 1)) > 0.1)).astype(np.float32)
    bootstrap = rng.normal(size=(1, n, 1)).astype(np.float32)
    for lmbda in (0.95, 0.0, 1.0):
        ref = jax_lambda(rewards, values, continues, bootstrap, lmbda)
        out = compute_lambda_values(*(torch.from_numpy(a) for a in (rewards, values, continues, bootstrap)), lmbda)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_hard_copy_cadence_matches_the_reference_block():
    """The loop's target-copy flags over blocks of gradient steps (``count_offset=0``:
    the count before the increment, so the first step copies) equal the flags the
    reference's ``make_train_block`` hands DreamerV2's step."""
    import jax
    import jax.numpy as jnp

    from sheeprl_tpu.utils.blocks import make_train_block
    from sheeprl_tpu_torch.utils.blocks import target_flags

    def step_fn(carry, batch, key, update_target):
        i, flags = carry
        return (i + 1, flags.at[i].set(update_target)), {}

    for freq in (1, 3, 100):
        block = make_train_block(step_fn, freq, 0)
        count = 0
        for n in (1, 3, 2, 4, 100, 5):
            carry = (jnp.asarray(0), jnp.zeros(n, bool))
            (_, flags), _ = block(carry, [jnp.zeros(1)] * n, jax.random.PRNGKey(0), count)
            assert target_flags(count, n, freq, count_offset=0).tolist() == [bool(f) for f in np.asarray(flags)], (freq, count, n)
            count += n
    assert target_flags(0, 1, 100, count_offset=0).tolist() == [True]
