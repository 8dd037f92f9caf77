"""P2E on DreamerV3: the exploration and finetuning steps of the PyTorch port against the
JAX package's.

Both packages build a tiny agent from the ``p2e_dv3_dummy`` exp (three ensemble
members, two exploration critics: ``intrinsic`` at weight 0.1 and ``extrinsic``, a task
reward, at weight 1) at ``test_torch_dv3_train.py``'s sizes (T 4, B 2, horizon 3); the
JAX parameters of every tree (world model, task actor, critic and target critic,
exploration actor, each exploration critic and its target, the stacked ensembles),
perturbed with seeded noise, are carried into the port (``params_from_jax``); both take
one step on the same numpy batch, from the same return moments, and the port is handed
the noise JAX draws from its key (``k_wm, k_img_e, k_a0_e, k_img_t, k_a0_t``), each
imagination's in fields of its own.

Exploration, f32, two cases: a discrete actor over the image and vector keys with the
target EMA on; a continuous actor over the vector key (its gradient crosses both
imaginations) with the EMA off. Compared: every new parameter, the Adam moments of
every optimizer (one per exploration critic among them), every target critic, the task
and per-critic return moments and every metric (``Rewards/intrinsic_{k}``,
``Loss/value_loss_exploration_{k}`` among them) at ``test_torch_dv3_train.py``'s limits
(``F32``); every trained tree moved.

Exploration at bf16-mixed (discrete): held as ``test_torch_dv3_bf16.py`` holds
DreamerV3's step, at its limits: each module's share of parameter changes off JAX's by
more than 0.1 lr at most 4 %, each Adam leaf's ``mu`` within 0.2 and ``nu`` within 0.4
relative norm (the image decoder's bias, which the reference sums in bf16, held to the
port's own f32 step), the losses within 5e-2 relative, at ``test_torch_dv3_bf16.py``'s
widths and seed 0. The readings of seeds 0-2 (``python -m tests.test_torch_p2e_dv3_train``)
are in ``print_bf16_readings``' docstring: seed 2 misses the actor's limits, where the
reference's bf16 task policy loss lies 17 % from its own float32 value and the port's
within 0.2 %.

Finetuning: the loop's parts of ``p2e_dv3_finetuning`` (``algos/p2e::finetuning_parts``)
over the carried trees: its captured step (eager on the CPU) against the reference's
DreamerV3 step on the task slice, with the task moments carried over; the untrained
trees, their optimizer states and the exploration critics' moments are left as they were.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_dv1_agent import ACTIONS_DIM, jax_ctx
from tests.test_torch_dv1_train import assert_moments_match, assert_params_match
from tests.test_torch_dv2_agent import perturbed
from tests.test_torch_dv3_agent import OBS_SPACE, TINY, _jitted_init
from tests.test_torch_dv3_train import B, DISCRETE, F32, HORIZON, STOCH, T, _adam_state, make_batch

SIZES = ["env.screen_size=64", f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}", f"algo.horizon={HORIZON}"]
CASES = {
    "discrete": dict(overrides=[], keys=(["rgb"], ["state"]), update_target=True),
    "continuous": dict(overrides=["env=continuous_dummy", "algo.cnn_keys.encoder=[]"], keys=([], ["state"]), update_target=False),
}
OPTIMIZED = ("world_model", "actor_task", "critic_task", "actor_exploration", "ensembles")
CRITICS = ("intrinsic", "extrinsic")
TARGETS = {"target_critic_task": "critic_task"}
# the return moments both packages start from (the first step's EMA reads them)
START_MOMENTS = {"task": (0.3, 1.7), "expl": {"intrinsic": (-0.2, 0.9), "extrinsic": (0.1, 2.5)}}


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def compose_pair(kind: str, precision: str = "32-true", extra=()):
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.config.core import compose as torch_compose

    overrides = ["exp=p2e_dv3_dummy", "env=discrete_dummy", *SIZES, *CASES[kind]["overrides"], f"mesh.precision={precision}", *extra]
    return jax_compose(overrides=overrides), torch_compose(overrides=[*overrides, "device=cpu"])


def build_pair(kind: str, precision: str = "32-true", seed: int = 0, perturb: float = 0.05, extra=()):
    """The JAX package's P2E-DV3 exploration step (jitted) and the port's, over the same
    carried parameters; ``extra`` overrides both configs further."""
    import jax

    from sheeprl_tpu.algos.p2e_dv3 import agent as jax_agent
    from sheeprl_tpu.algos.p2e_dv3.p2e_dv3_exploration import make_train_step as jax_make_train_step
    from sheeprl_tpu_torch.algos.p2e_dv3.agent import critic_configs

    jcfg, _ = compose_pair(kind, precision, extra)
    continuous = kind == "continuous"
    with _jitted_init():
        jwm, jactor, jcritic, jens, params, _ = jax_agent.build_agent(jax_ctx(precision, seed), ACTIONS_DIM, continuous, jcfg, OBS_SPACE)
    jstep, jinit, jinit_moments = jax_make_train_step(jwm, jactor, jcritic, jens, jcfg, *CASES[kind]["keys"], critic_configs(jcfg))
    params = perturbed(params, seed + 100, perturb)
    return dict(
        jstep=jax.jit(jstep), jinit=jinit, jinit_moments=jinit_moments, params=params, jcfg=jcfg, jparts=(jwm, jactor, jcritic),
        **build_port(params, kind, precision, seed, extra),
    )


def build_port(params, kind: str, precision: str, seed: int = 0, extra=()):
    """The port's agent over the carried ``params``, its exploration step and config."""
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent
    from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import make_train_step
    from sheeprl_tpu_torch.parallel.context import RunContext, compute_dtype

    _, tcfg = compose_pair(kind, precision, extra)
    ctx = RunContext(torch.device("cpu"), seed, compute_dtype=compute_dtype(precision))
    modules, _ = build_agent(ctx, ACTIONS_DIM, kind == "continuous", tcfg, OBS_SPACE)
    assert set(modules) == set(params) and list(modules["critics_exploration"]) == list(CRITICS)
    for name, state in params_from_jax(params, modules).items():
        modules[name].load_state_dict(state)
    step, init = make_train_step(modules, tcfg, *CASES[kind]["keys"])
    return dict(modules=modules, step=step, init=init, cfg=tcfg)


def run_port(port, kind: str, seed: int = 3):
    """The port's step on ``run_pair``'s batch, moments and JAX draws."""
    import jax

    batch = make_batch(seed, kind == "continuous")
    opt = port["init"]()
    draws = p2e_dv3_draws(jax.random.PRNGKey(seed), kind == "continuous")
    moments, metrics = port["step"](opt, start_moments(False), {k: torch.from_numpy(v) for k, v in batch.items()}, CASES[kind]["update_target"], draws=draws)
    return opt, moments, metrics


def _imagination_noise(k_img, k_a0, is_continuous: bool):
    """One imagination's noise as the reference draws it: the first action's from
    ``k_a0``, then each step's prior and action from ``split(k_img, horizon)``."""
    import jax

    def actor_noise(k, n):
        if is_continuous:
            return (jax.random.normal(k, (n, int(sum(ACTIONS_DIM)))),)
        ks = jax.random.split(k, len(ACTIONS_DIM))
        return tuple(jax.random.gumbel(ks[i], (n, d)) for i, d in enumerate(ACTIONS_DIM))

    priors, actions = [], []
    for k in jax.random.split(k_img, HORIZON):
        k_dyn, k_act = jax.random.split(k)
        priors.append(jax.random.gumbel(k_dyn, (T * B, STOCH, DISCRETE)))
        actions.append(actor_noise(k_act, T * B))
    stacked = tuple(np.stack([a[i] for a in actions]) for i in range(len(actions[0])))
    return actor_noise(k_a0, T * B), np.stack(priors), stacked


def p2e_dv3_draws(key, is_continuous: bool):
    """The noise the reference's P2E-DV3 step draws from ``key``."""
    import jax

    from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import TrainDraws
    from tests.test_torch_dv1_train import to_t

    k_wm, k_img_e, k_a0_e, k_img_t, k_a0_t = jax.random.split(key, 5)
    prior, post = [], []
    for k in jax.random.split(k_wm, T):
        k1, k2 = jax.random.split(k)
        prior.append(jax.random.gumbel(k1, (B, STOCH, DISCRETE)))
        post.append(jax.random.gumbel(k2, (B, STOCH, DISCRETE)))
    expl = _imagination_noise(k_img_e, k_a0_e, is_continuous)
    task = _imagination_noise(k_img_t, k_a0_t, is_continuous)
    return TrainDraws(*to_t((np.stack(prior), np.stack(post), *expl, *task)))


def start_moments(jax_side: bool):
    import jax.numpy as jnp

    from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments

    def one(low, high):
        if jax_side:
            return {"low": jnp.asarray(low), "high": jnp.asarray(high)}
        m = init_moments()
        m["low"].fill_(low)
        m["high"].fill_(high)
        return m

    return {"task": one(*START_MOMENTS["task"]), "expl": {k: one(*v) for k, v in START_MOMENTS["expl"].items()}}


def run_pair(pair, kind: str, seed: int = 3):
    import jax
    import jax.numpy as jnp

    continuous = kind == "continuous"
    batch = make_batch(seed, continuous)
    flag = CASES[kind]["update_target"]
    jparams = jax.tree.map(jnp.asarray, pair["params"])
    jout = pair["jstep"](jparams, pair["jinit"](jparams), start_moments(True), {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(seed), flag)
    return jax.device_get(jout), run_port(pair, kind, seed)


@pytest.fixture(scope="module", params=sorted(CASES))
def f32_run(request):
    pair = build_pair(request.param)
    return request.param, pair, run_pair(pair, request.param)


def test_exploration_step_f32_parameters_match_jax(f32_run):
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax

    kind, pair, (jout, _) = f32_run
    modules = pair["modules"]
    assert_params_match(modules, jout[0], F32["params"])
    old = params_from_jax(pair["params"], modules)
    for name in (*OPTIMIZED, "critics_exploration"):
        assert any(not torch.equal(v, old[name][k]) for k, v in modules[name].state_dict().items()), name
    # each target critic: blended towards its updated critic where the flag is set, as it was where not
    new = {name: m.state_dict() for name, m in modules.items()}
    pairs = [(new["target_critic_task"], old["target_critic_task"], new["critic_task"], "")]
    pairs += [({k[len(c) + 8:]: v for k, v in new["critics_exploration"].items() if k.startswith(f"{c}.target.")},
               {k[len(c) + 8:]: v for k, v in old["critics_exploration"].items() if k.startswith(f"{c}.target.")},
               {k[len(c) + 8:]: v for k, v in new["critics_exploration"].items() if k.startswith(f"{c}.module.")}, c) for c in CRITICS]
    tau = pair["cfg"].algo.critic.tau
    for target, before, critic, name in pairs:
        assert target
        for k, v in target.items():
            want = (1 - tau) * before[k] + tau * critic[k] if CASES[kind]["update_target"] else before[k]
            torch.testing.assert_close(v, want, rtol=0, atol=1e-6, msg=lambda m: f"target {name}.{k}: {m}")


def test_exploration_step_f32_optimizer_moments_match_jax(f32_run):
    _, pair, (jout, (opt, _, _)) = f32_run
    modules = pair["modules"]
    assert set(opt) == set(jout[1]) == {*OPTIMIZED, "critics_exploration"}
    assert_moments_match(opt, jout[1], modules, {n: n for n in OPTIMIZED})
    critics = {k: modules["critics_exploration"][k]["module"] for k in CRITICS}
    assert list(opt["critics_exploration"]) == list(CRITICS)
    assert_moments_match(opt["critics_exploration"], jout[1]["critics_exploration"], critics, {k: k for k in CRITICS})


def test_exploration_step_f32_return_moments_and_metrics_match_jax(f32_run):
    _, _, (jout, (_, moments, metrics)) = f32_run
    for path, got, want in [("task", moments["task"], jout[2]["task"])] + [(k, moments["expl"][k], jout[2]["expl"][k]) for k in CRITICS]:
        for k in ("low", "high"):
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-7, err_msg=f"{path}.{k}")
    assert set(metrics) == set(jout[3])
    assert {"Rewards/intrinsic_intrinsic", "Loss/value_loss_exploration_intrinsic", "Loss/value_loss_exploration_extrinsic"} <= set(metrics)
    for name in metrics:
        np.testing.assert_allclose(metrics[name].item(), float(jout[3][name]), rtol=F32["metric_rtol"], atol=1e-7, err_msg=name)
    assert metrics["Rewards/intrinsic_intrinsic"].item() > 0


# ---------------------------------------------------------------------------------------
# bf16-mixed
# ---------------------------------------------------------------------------------------

STEP_ATOL_OF_LR, MAX_OFF_SHARE = 0.1, 0.04
MU_RTOL, NU_RTOL = 0.2, 0.4
METRIC_RTOL = 5e-2
SUMMED_IN_BF16 = {"world_model.observation_model_cnn.head.bias"}
# test_torch_dv3_bf16.py's widths (test_torch_dv3_agent.py's TINY): the dummy exp's CNN
# multiplier of 2 puts a LayerNorm over 2 channels after the first conv, whose scale's
# gradient is a difference of terms that bf16 rounds apart
BF16_WIDTHS = [o for o in TINY if o.startswith("algo.") and o != "algo=dreamer_v3_XS"]


def bf16_readings(seed: int = 0) -> dict:
    """One discrete exploration step at bf16-mixed in both packages, and what the test
    compares: per module, the share of parameter changes off JAX's by more than
    ``STEP_ATOL_OF_LR`` of its lr; per Adam leaf, the relative norm distance of ``mu``
    and ``nu`` from JAX's (from the port's own f32 step's for ``SUMMED_IN_BF16``); the
    relative distance of the losses."""
    from sheeprl_tpu_torch.algos.dreamer_v3.params import parameter_list_from_jax, params_from_jax

    pair = build_pair("discrete", "bf16-mixed", seed=seed, extra=BF16_WIDTHS)
    modules = pair["modules"]
    assert modules["world_model"].rssm.recurrent_model.rnn.linear.compute_dtype == torch.bfloat16
    old = params_from_jax(pair["params"], modules)
    jout, (opt, _, metrics) = run_pair(pair, "discrete", seed + 3)
    new_jax = params_from_jax(jout[0], modules)
    a = pair["cfg"].algo
    lr = {"world_model": a.world_model.optimizer.lr, "ensembles": a.ensembles.optimizer.lr, "critics_exploration": a.critic.optimizer.lr}
    out = {"off_share": {}, "mu": {}, "nu": {}, "metrics": {}}
    for name, module in modules.items():
        step_lr = lr.get(name, (a.actor if name.startswith("actor") else a.critic).optimizer.lr)
        off = torch.cat([
            ((v.float() - old[name][k]) - (new_jax[name][k] - old[name][k])).abs().flatten() > STEP_ATOL_OF_LR * step_lr
            for k, v in module.state_dict().items()
        ])
        out["off_share"][name] = off.float().mean().item()

    f32_opt = run_port(build_port(pair["params"], "discrete", "32-true", seed, BF16_WIDTHS), "discrete", seed + 3)[0]
    groups = [(n, opt[n], jout[1][n], f32_opt[n], modules[n]) for n in OPTIMIZED]
    groups += [(f"critics_exploration.{k}", opt["critics_exploration"][k], jout[1]["critics_exploration"][k], f32_opt["critics_exploration"][k],
                modules["critics_exploration"][k]["module"]) for k in CRITICS]
    for name, got_state, jstate, f32_state, module in groups:
        ref = _adam_state(jstate)
        leaves = [k for k, _ in module.named_parameters()]
        for moment in ("mu", "nu"):
            want = parameter_list_from_jax(getattr(ref, moment), module, name)
            for leaf, got, exp, f in zip(leaves, got_state[moment], want, f32_state[moment]):
                if f"{name}.{leaf}" in SUMMED_IN_BF16:
                    exp = f
                err, norm = (got - exp).norm().item(), exp.norm().item()
                out[moment][f"{name}.{leaf}"] = err / norm if norm > 0 else (0.0 if err == 0 else float("inf"))
    for name in (k for k in metrics if k.startswith("Loss/")):
        out["metrics"][name] = abs(metrics[name].item() - float(jout[3][name])) / abs(float(jout[3][name]))
    out["finite"] = all(np.isfinite(v.item()) for v in metrics.values())
    return out


def print_bf16_readings(seeds) -> None:
    """The readings behind the bf16 limits, for ``seeds``: the largest share of parameter
    changes off JAX's (and which module), the largest relative distance of any Adam
    ``mu`` and ``nu`` leaf (and which), and of the losses. ``JAX_PLATFORMS=cpu python -m
    tests.test_torch_p2e_dv3_train [seeds, default 0,1,2]``.

    Readings (CPU, seeds 0, 1, 2): parameter changes off by more than 0.1 lr 1.4 %, 1.6 %
    (world model) and 7.8 % (task actor); ``mu`` 0.107, 0.150, 0.176 and ``nu`` 0.202,
    0.323, 0.292 relative norm (actor leaves); losses 3.0e-2, 1.8e-2 and 0.142 (the task
    policy loss). At seed 2 the reference's bf16 step is the one that moves: its task
    policy loss reads 0.0632 against its own float32 step's 0.0542, where the port's bf16
    step reads 0.0542 (the two float32 steps agree to 1e-6)."""
    import json

    for seed in seeds:
        r = bf16_readings(seed)
        print(json.dumps({
            "seed": seed,
            "max_off_share": max(r["off_share"].items(), key=lambda kv: kv[1]),
            "max_mu_rel": max(r["mu"].items(), key=lambda kv: kv[1]),
            "max_nu_rel": max(r["nu"].items(), key=lambda kv: kv[1]),
            "max_metric_rel": max(r["metrics"].items(), key=lambda kv: kv[1]),
            "finite": r["finite"],
        }), flush=True)


def test_exploration_step_bf16_matches_jax_bf16():
    readings = bf16_readings()
    for name, share in readings["off_share"].items():
        assert share <= MAX_OFF_SHARE, (name, share)
    for moment, rtol in (("mu", MU_RTOL), ("nu", NU_RTOL)):
        for leaf, rel in readings[moment].items():
            assert rel <= rtol, (leaf, moment, rel)
    for name, rel in readings["metrics"].items():
        assert rel <= METRIC_RTOL, (name, rel)
    assert readings["finite"]


# ---------------------------------------------------------------------------------------
# finetuning
# ---------------------------------------------------------------------------------------


def test_finetuning_step_matches_jax_on_the_task_slice(tmp_path, monkeypatch):
    import copy

    import jax
    import jax.numpy as jnp

    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as jax_dv3_step
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_finetuning
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.parallel.context import RunContext
    from tests.test_torch_dv3_train import jax_draws

    kind, seed = "continuous", 3
    pair = build_pair(kind)
    jwm, jactor, jcritic = pair["jparts"]
    jstep, jinit = jax_dv3_step(jwm, jactor, jcritic, pair["jcfg"], [], ["state"], {})
    view = {"world_model": "world_model", "actor": "actor_task", "critic": "critic_task", "target_critic": "target_critic_task"}
    jparams = {k: jax.tree.map(jnp.asarray, pair["params"][v]) for k, v in view.items()}
    batch = make_batch(seed, True)
    jout = jax.device_get(jax.jit(jstep, static_argnums=(5,))(
        jparams, jinit(jparams), start_moments(True)["task"], {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(seed), True
    ))

    # the finetuning run's parts, as its entry builds them (the loop itself is not run)
    ckpt = CheckpointManager(tmp_path / "expl").save(1, {"params": {}})
    overrides = ["exp=p2e_dv3_dummy", "env=continuous_dummy", "algo.cnn_keys.encoder=[]", *SIZES, "mesh.precision=32-true",
                 "algo.name=p2e_dv3_finetuning", f"checkpoint.exploration_ckpt_path={ckpt}", "device=cpu"]
    cfg = compose(overrides=overrides)
    monkeypatch.setattr(p2e_dv3_finetuning, "run_loop", lambda ctx, cfg, setup, keys, handled: setup(OBS_SPACE, ACTIONS_DIM, True, str(tmp_path), None))
    parts = p2e_dv3_finetuning.main(RunContext(torch.device("cpu"), 0), cfg)
    assert parts.count_offset == 0 and parts.exploration is None and parts.task_player is not None
    assert float(parts.clip_reward(np.array([3.0]))[0]) == 1.0
    for name, state in params_from_jax(pair["params"], parts.modules).items():
        parts.modules[name].load_state_dict(state)
    moments = parts.extra_state["moments"]
    start = start_moments(False)
    moments["task"]["low"].copy_(start["task"]["low"])
    moments["task"]["high"].copy_(start["task"]["high"])
    for k in CRITICS:
        for end in ("low", "high"):
            moments["expl"][k][end].copy_(start["expl"][k][end])
    before = {n: copy.deepcopy(m.state_dict()) for n, m in parts.modules.items()}
    opt_before = copy.deepcopy(parts.opt_states)

    example = {"table": torch.ones(1, dtype=torch.int64), "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}
    step, _ = parts.make_step(example)
    for dst, src in zip(step.inputs["draws"], jax_draws(jax.random.PRNGKey(seed), True)):
        for d, s in zip(dst if isinstance(dst, tuple) else (dst,), src if isinstance(src, tuple) else (src,)):
            d.copy_(s)
    metrics = step()

    task = {k: parts.modules[v] for k, v in view.items()}
    assert_params_match(task, jout[0], F32["params"])
    names = {"world_model": "world_model", "actor": "actor", "critic": "critic"}
    task_opt = {k: parts.opt_states[view[k]] for k in names}
    assert_moments_match(task_opt, jout[1], task, names)
    for k in ("low", "high"):
        np.testing.assert_allclose(moments["task"][k].item(), float(jout[2][k]), rtol=1e-5, atol=1e-7)
    for name in ("Loss/world_model_loss", "Loss/policy_loss", "Loss/value_loss", "Grads/world_model", "Grads/actor", "Grads/critic"):
        np.testing.assert_allclose(metrics[name].item(), float(jout[3][name]), rtol=F32["metric_rtol"], atol=1e-7, err_msg=name)
    for name in ("actor_exploration", "critics_exploration", "ensembles"):
        assert all(torch.equal(v, before[name][k]) for k, v in parts.modules[name].state_dict().items()), name
    for name in ("actor_exploration", "ensembles"):
        assert int(parts.opt_states[name]["count"]) == 0 and all(torch.equal(a, b) for a, b in zip(parts.opt_states[name]["mu"], opt_before[name]["mu"]))
    for k, (low, high) in START_MOMENTS["expl"].items():
        assert (moments["expl"][k]["low"].item(), moments["expl"][k]["high"].item()) == pytest.approx((low, high))


def test_exploration_copy_cadence_is_count_offset_zero(monkeypatch, tmp_path):
    """The exploration entry hands the loop ``count_offset=0`` (the reference's block is
    ``make_train_block(step, f, 0)``), DreamerV3's own entry 1; both hand it their moments."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3
    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.parallel.context import RunContext
    from sheeprl_tpu_torch.utils.blocks import target_flags

    fake = lambda ctx, cfg, setup, *a, **k: setup(OBS_SPACE, ACTIONS_DIM, False, str(tmp_path), None)  # noqa: E731
    for module, exp, offset in ((p2e_dv3_exploration, "p2e_dv3_dummy", 0), (dreamer_v3, "dreamer_v3_dummy", 1)):
        monkeypatch.setattr(module, "run_loop", fake)
        cfg = compose(overrides=[f"exp={exp}", "env=discrete_dummy", "device=cpu", f"log_root={tmp_path}", "env.screen_size=64"])
        parts = module.main(RunContext(torch.device("cpu"), 0), cfg)
        assert parts.count_offset == offset and parts.exploration is None and "moments" in parts.extra_state
    assert target_flags(0, 3, 2, 0).tolist() == [True, False, True]
    assert set(parts.opt_states) == {"world_model", "actor", "critic"}


def test_build_refuses_without_an_intrinsic_critic():
    from sheeprl_tpu.algos.p2e_dv3.agent import build_agent as jax_build_agent
    from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent
    from sheeprl_tpu_torch.parallel.context import RunContext

    extra = ["algo.critics_exploration.intrinsic.weight=0"]
    jcfg, tcfg = compose_pair("discrete", extra=extra)
    for build, ctx, cfg in ((jax_build_agent, jax_ctx(), jcfg), (build_agent, RunContext(torch.device("cpu"), 0), tcfg)):
        with _jitted_init(), pytest.raises(RuntimeError, match="intrinsic critic"):
            build(ctx, ACTIONS_DIM, False, cfg, OBS_SPACE)


# ---------------------------------------------------------------------------------------
# the ensembles of P2E-DV3
# ---------------------------------------------------------------------------------------


def test_ensemble_loss_and_its_gradient_match_jax():
    """P2E-DV3's ensemble loss (the members' squared error, summed over the features, a
    mean over the rows, summed over the members) on SiLU members with LayerNorm, as P2E-DV3
    builds them, and its gradient, against the reference's ``ensemble_loss`` (atol = rtol
    = 1e-5, float32)."""
    import jax
    import jax.numpy as jnp

    from sheeprl_tpu.algos.p2e import build_ensembles, ensemble_loss as jax_loss
    from sheeprl_tpu_torch.algos.dreamer_v3.params import module_state_from_jax, parameter_list_from_jax
    from sheeprl_tpu_torch.algos.p2e import Ensembles, ensemble_loss

    n, d_in, d_out, dense, layers = 3, 12, 6, 16, 2
    mlp, stacked = build_ensembles(jax.random.PRNGKey(0), n, d_in, d_out, dense, layers, "silu", True, jnp.float32)
    params = perturbed(stacked, 1, 0.1)
    ens = Ensembles(n, d_in, d_out, dense, layers, "silu", True)
    ens.load_state_dict(module_state_from_jax(params["params"], ens, "ensembles"))
    rng = np.random.default_rng(2)
    x, targets = rng.normal(size=(5, 4, d_in)).astype(np.float32), rng.normal(size=(4, 4, d_out)).astype(np.float32)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jax_loss(mlp, p, x, targets)))(params)
    loss = ensemble_loss(ens, torch.from_numpy(x), torch.from_numpy(targets))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(loss, list(ens.parameters()))
    for got, want in zip(grads, parameter_list_from_jax(jax.device_get(jg), ens, "ensembles")):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_build_ensembles_takes_its_activation_explicitly():
    """P2E-DV3's ensembles are SiLU with a LayerNorm at eps 1e-5 (DreamerV3's configs have
    no ``dense_act``); P2E-DV2's keep ``algo.dense_act`` and ``algo.layer_norm``."""
    from sheeprl_tpu_torch.algos.p2e_dv2.agent import build_agent as dv2_build_agent
    from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.parallel.context import RunContext

    _, tcfg = compose_pair("discrete")
    assert "dense_act" not in tcfg.algo
    ens = build_agent(RunContext(torch.device("cpu"), 0), ACTIONS_DIM, False, tcfg, OBS_SPACE)[0]["ensembles"]
    assert ens.act is torch.nn.functional.silu and ens.norms is not None and ens.norms[0].eps == 1e-5
    wm_cfg = tcfg.algo.world_model
    assert ens.dense[0].weight.shape[1] == 2 + wm_cfg.recurrent_model.recurrent_state_size + wm_cfg.stochastic_size * wm_cfg.discrete_size
    cfg = compose(overrides=["exp=p2e_dv2_dummy", "env=discrete_dummy", "device=cpu"])
    dv2 = dv2_build_agent(RunContext(torch.device("cpu"), 0), ACTIONS_DIM, False, cfg, OBS_SPACE)[0]["ensembles"]
    from sheeprl_tpu_torch.models.blocks import _activation

    assert dv2.act is _activation(cfg.algo.dense_act) and (dv2.norms is not None) == cfg.algo.layer_norm


if __name__ == "__main__":
    import sys

    print_bf16_readings([int(x) for x in (sys.argv[1] if len(sys.argv) > 1 else "0,1,2").split(",")])
