"""P2E on DreamerV1: the exploration step of the PyTorch port against the JAX package's.

Both packages build a tiny agent from the ``p2e_dv1_dummy`` exp (three ensemble members);
the JAX parameters of all six trees (world model, task and exploration actors and
critics, the stacked ensembles), perturbed with seeded noise, are carried into the port;
both take one ``train_step`` on the same numpy batch (``test_torch_dv2_train.py``'s), and
the port is handed the noise JAX draws from its key: the unroll's, then each
imagination's (the exploration actor's from ``k_img_e``, the task actor's from
``k_img_t``) in a field of its own. Two cases: a discrete actor over the image and vector
keys, and a continuous actor over the vector key with the continue head on and
``kl_free_nats=0``. Compared afterwards: every new parameter of the six trees, the Adam
moments of the six optimizers and the metrics, ``Rewards/intrinsic`` among them, at the
limits of ``test_torch_dv2_train.py`` (float32).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_dv1_agent import ACTIONS_DIM, jax_ctx, jitted_init
from tests.test_torch_dv1_train import B, HORIZON, STOCH, T, assert_moments_match, assert_params_match, imagination_draws, to_t, unroll_draws
from tests.test_torch_dv2_agent import perturbed
from tests.test_torch_dv2_train import make_batch
from tests.test_torch_dv3_agent import OBS_SPACE
from tests.test_torch_dv3_train import F32

SIZES = [f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}", f"algo.horizon={HORIZON}"]
CASES = {
    "discrete": dict(overrides=[], keys=(["rgb"], ["state"]), update_target=True),
    "continuous": dict(
        overrides=["env=continuous_dummy", "algo.cnn_keys.encoder=[]", "algo.world_model.use_continues=True", "algo.world_model.kl_free_nats=0"],
        keys=([], ["state"]),
        update_target=False,
    ),
}
METRICS = (
    "Loss/world_model_loss", "Loss/observation_loss", "Loss/reward_loss", "Loss/state_loss", "Loss/continue_loss",
    "State/kl", "State/post_entropy", "State/prior_entropy", "Loss/ensemble_loss",
    "Loss/policy_loss_exploration", "Loss/value_loss_exploration", "Loss/policy_loss_task", "Loss/value_loss_task",
    "Rewards/intrinsic", "Values_exploration/predicted_values", "Values_exploration/lambda_values",
)
OPTIMIZED = ("world_model", "actor_task", "critic_task", "actor_exploration", "critic_exploration", "ensembles")


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def build_p2e_pair(version: int, kind: str, seed: int = 0, perturb: float = 0.05):
    """The JAX package's P2E exploration step (jitted) and the port's, over the same
    carried parameters; ``version``: 1 or 2 (the DreamerV1 or DreamerV2 stack)."""
    import importlib

    import jax

    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.config.core import compose as torch_compose
    from sheeprl_tpu_torch.parallel.context import RunContext

    name = f"p2e_dv{version}"
    overrides = [f"exp={name}_dummy", "env=discrete_dummy", *SIZES, *CASES[kind]["overrides"], "mesh.precision=32-true"]
    jcfg, tcfg = jax_compose(overrides=overrides), torch_compose(overrides=[*overrides, "device=cpu"])
    jax_agent = importlib.import_module(f"sheeprl_tpu.algos.{name}.agent")
    jax_train = importlib.import_module(f"sheeprl_tpu.algos.{name}.{name}_exploration")
    port_agent = importlib.import_module(f"sheeprl_tpu_torch.algos.{name}.agent")
    port_train = importlib.import_module(f"sheeprl_tpu_torch.algos.{name}.{name}_exploration")
    dv_agent = importlib.import_module(f"sheeprl_tpu.algos.dreamer_v{version}.agent")
    continuous = kind == "continuous"
    with jitted_init(jax_agent, dv_agent):
        jwm, jactor, jcritic, jens, params, _ = jax_agent.build_agent(jax_ctx("fp32", seed), ACTIONS_DIM, continuous, jcfg, OBS_SPACE)
    jstep, jinit = jax_train.make_train_step(jwm, jactor, jcritic, jens, jcfg, *CASES[kind]["keys"])
    params = perturbed(params, seed + 100, perturb)
    modules, _ = port_agent.build_agent(RunContext(torch.device("cpu"), seed), ACTIONS_DIM, continuous, tcfg, OBS_SPACE)
    assert set(modules) == set(params)
    for mod_name, state in params_from_jax(params, modules).items():
        modules[mod_name].load_state_dict(state)
    step, init = port_train.make_train_step(modules, tcfg, *CASES[kind]["keys"])
    return dict(jstep=jax.jit(jstep), jinit=jinit, params=params, modules=modules, step=step, init=init, cfg=tcfg, version=version)


def p2e_draws(version: int, key, is_continuous: bool, discrete: int = 4):
    """The noise the reference's P2E step draws from ``key``: ``k_wm, k_img_e, k_img_t =
    split(key, 3)``, then the unroll's and each imagination's as DreamerV1 or DreamerV2
    split theirs."""
    import importlib

    import jax

    TrainDraws = importlib.import_module(f"sheeprl_tpu_torch.algos.p2e_dv{version}.p2e_dv{version}_exploration").TrainDraws
    k_wm, k_img_e, k_img_t = jax.random.split(key, 3)
    stoch = (STOCH,) if version == 1 else (STOCH, discrete)
    prior, post = unroll_draws(k_wm, stoch, "normal" if version == 1 else "gumbel")
    expl_actor, expl_prior = imagination_draws(k_img_e, is_continuous, (T * B, *stoch))
    task_actor, task_prior = imagination_draws(k_img_t, is_continuous, (T * B, *stoch))
    return TrainDraws(*to_t((prior, post, expl_actor, expl_prior, task_actor, task_prior)))


def run_p2e_pair(pair, kind: str, seed: int = 3):
    import jax
    import jax.numpy as jnp

    continuous = kind == "continuous"
    batch = make_batch(seed, continuous)
    jparams = jax.tree.map(jnp.asarray, pair["params"])
    args = (jparams, pair["jinit"](jparams), {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(seed))
    if pair["version"] == 2:
        args += (jnp.asarray(CASES[kind]["update_target"]),)
    jout = jax.device_get(pair["jstep"](*args))
    opt = pair["init"]()
    draws = p2e_draws(pair["version"], jax.random.PRNGKey(seed), continuous)
    _, metrics = pair["step"](opt, {}, {k: torch.from_numpy(v) for k, v in batch.items()}, CASES[kind]["update_target"], draws=draws)
    return jout, (opt, metrics)


def check_p2e_step(pair, run, metrics_names):
    """Every tree's new parameters, every optimizer's moments, the metrics; each trained
    tree moved."""
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax

    jout, (opt, metrics) = run
    assert_params_match(pair["modules"], jout[0], F32["params"])
    assert_moments_match(opt, jout[1], pair["modules"], {n: n for n in OPTIMIZED})
    assert set(metrics) == set(jout[2])
    for name in metrics_names:
        np.testing.assert_allclose(metrics[name].item(), float(jout[2][name]), rtol=F32["metric_rtol"], atol=1e-7, err_msg=name)
    old = params_from_jax(pair["params"], pair["modules"])
    for name in OPTIMIZED:
        assert any(not torch.equal(v, old[name][k]) for k, v in pair["modules"][name].state_dict().items()), name
    assert metrics["Rewards/intrinsic"].item() > 0


@pytest.mark.parametrize("kind", sorted(CASES))
def test_exploration_step_f32_matches_jax(kind):
    pair = build_p2e_pair(1, kind)
    check_p2e_step(pair, run_p2e_pair(pair, kind), METRICS)
