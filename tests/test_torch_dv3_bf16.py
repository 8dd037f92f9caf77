"""``mesh.precision=bf16-mixed`` in the PyTorch port against the JAX package at the same
precision: the size-XS player, and a whole DreamerV3 training step.

Both packages compute in bfloat16 over float32 parameters, layer by layer (Flax's
``dtype=``, the port's ``compute_dtype``), but they round at other places (a bias added
after or inside the matmul, a fused or unfused activation), so the outputs agree to
bf16's precision, not bit for bit.

Tolerances. Player: the forward logits (the posterior's, from JAX's recurrent state and
the observation, and the actor's, from JAX's latent) atol 5e-2, since bf16 keeps ~3
significant digits and the XS network chains ~10 layers; and the greedy actions of the
two players, each on its own state, must agree on at least 99 % of 256 seeded
observations (the measure of ``sheeprl_tpu/precision/parity.py``). The players' states
are not compared entry by entry: a categorical mode (the initial state's ``z0``) or
sample whose top two logits tie within bf16's rounding picks another class in the other
package, a discrete step that later layers carry on.

Training step, image and vector keys, both actors. The first Adam step moves each
parameter by ``lr * g / (|g| + eps)``, about ``lr`` with the gradient's sign, so the new
parameters say little; compared instead:

- the parameter change (new minus old) of each module, against JAX's change: at most 4 %
  of a module's entries may differ by more than 0.1 of its ``lr`` (the target critic is
  held to its critic's). Those are the gradients whose sign bf16's rounding decides: at
  seeds 0-2, both actors, 0.07-2.6 % of the entries (the most, the continuous actor's
  policy); a step that updates nothing or follows wrong gradients misses on ~50-100 %;
- each leaf's Adam ``mu`` (the clipped gradient) by relative norm, ``||port - jax|| <=
  0.2 ||jax||``, and ``nu`` (its square) at twice that: readings at most 0.136 and
  0.233. One leaf is held to the port's own float32 step instead (which
  ``test_torch_dv3_train.py`` holds to JAX's float32 step): the image decoder's bias,
  whose gradient sums T·B·64·64 cotangents. The reference adds that bias in bf16, so its
  gradient is a bf16 ``reduce_sum``, 13-66 % off JAX's own float32 value in the
  readings; the port accumulates the same sum in float32 and stays within 1.2 % of it;
- the losses and the ``Grads/*`` norms, rtol 5e-2 (readings at most 1.2e-2 and
  2.2e-2); a Gumbel-max draw near a tie may go the other way in bf16.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_dv3_agent import OBS_SPACE, _jitted_init, obs_batch, to_torch
from tests.test_torch_dv3_train import LOSSES, METRICS, _adam_state, build_port_step, build_train_pair, run_pair, run_port

XS = ["exp=dreamer_v3_dummy", "algo=dreamer_v3_XS", "env=discrete_dummy", "env.screen_size=64", "mesh.precision=bf16-mixed"]
PLAYER_ATOL = 5e-2
MIN_AGREEMENT = 0.99
STEP_ATOL_OF_LR, MAX_OFF_SHARE = 0.1, 0.04
MU_RTOL, NU_RTOL = 0.2, 0.4
METRIC_RTOL = 5e-2
GRADS = ("Grads/world_model", "Grads/actor", "Grads/critic")
# gradients the reference sums in bfloat16 (see the module's docstring)
SUMMED_IN_BF16 = {"world_model.observation_model_cnn.head.bias"}


def test_xs_player_bf16_matches_jax_bf16():
    from sheeprl_tpu.algos.dreamer_v3.agent import PlayerState as JaxPlayerState
    from sheeprl_tpu.algos.dreamer_v3.agent import WorldModel
    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
    from sheeprl_tpu.algos.dreamer_v3.agent import make_player_step as jax_make_player_step
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu.parallel.mesh import MeshContext, build_mesh
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerState, build_agent, make_player_step
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.parallel.context import make_run_context

    jcfg, tcfg = jax_compose(overrides=XS), compose(overrides=[*XS, "device=cpu"])
    actions_dim, n = (4,), 256
    jctx = MeshContext(mesh=build_mesh(devices=jax.devices()[:1]), precision="bf16-mixed", seed=0)
    with _jitted_init():
        jwm, jactor, _, params, _ = jax_build_agent(jctx, actions_dim, False, jcfg, OBS_SPACE)
    params = jax.device_get(params)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda x: (x + rng.normal(0.0, 0.02, x.shape)).astype(np.float32), params)
    ctx = make_run_context(tcfg)
    assert ctx.compute_dtype == torch.bfloat16
    wm, actor, critic, target, _ = build_agent(ctx, actions_dim, False, tcfg, OBS_SPACE)
    modules = {"world_model": wm, "actor": actor, "critic": critic, "target_critic": target}
    for name, state in params_from_jax(params, modules).items():
        modules[name].load_state_dict(state)

    stoch, discrete = jcfg.algo.world_model.stochastic_size, jcfg.algo.world_model.discrete_size
    rec = jcfg.algo.world_model.recurrent_model.recurrent_state_size
    jstep = jax.jit(jax_make_player_step(jwm, jactor, actions_dim, discrete), static_argnames=("greedy",))
    jlogits = jax.jit(lambda p, z: jactor.apply(p, z, None, True)[1][0].logits)
    jpost = jax.jit(
        lambda p, h, o: jwm.apply(p, h, jwm.apply(p, o, method=WorldModel.encode), None, False, method=WorldModel.representation)[0]
    )
    tstep = make_player_step(wm, actor, actions_dim, discrete)
    jstate = JaxPlayerState(np.zeros((n, rec), np.float32), np.zeros((n, stoch * discrete), np.float32), np.zeros((n, 4), np.float32))
    tstate = PlayerState(*(torch.from_numpy(x) for x in jstate))
    obs_rng = np.random.default_rng(2)
    for t in range(2):
        obs = obs_batch(obs_rng, n)
        is_first = np.full((n, 1), 1.0 if t == 0 else 0.0, np.float32)
        jactions, _, jstate = jstep(params, jstate, obs, is_first, jax.random.PRNGKey(t), greedy=True)
        draw = torch.from_numpy(np.array(jstate.stochastic_state).reshape(n, stoch, discrete))
        jlatent = np.concatenate([np.asarray(jstate.stochastic_state), np.asarray(jstate.recurrent_state)], -1)
        jrec = np.asarray(jstate.recurrent_state)
        with torch.no_grad():
            tactions, _, tstate = tstep(tstate, to_torch(obs), torch.from_numpy(is_first), greedy=True, draws=(draw, None))
            tlog = actor(torch.from_numpy(jlatent), greedy=True)[1][0].logits
            tpost, _ = wm.representation(torch.from_numpy(jrec), wm.encode(to_torch(obs)), sample=False)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlogits(params["actor"], jlatent)), atol=PLAYER_ATOL)
        np.testing.assert_allclose(tpost.numpy(), np.asarray(jpost(params["world_model"], jrec, obs)), atol=PLAYER_ATOL)
        agreement = float((tactions[0].argmax(-1).numpy() == np.asarray(jactions[0]).argmax(-1)).mean())
        assert agreement >= MIN_AGREEMENT, agreement


def train_step_readings(kind: str, seed: int = 0) -> dict:
    """One whole step with the image and vector keys at bf16-mixed in both packages, and
    what the test compares: per module, the share of parameter changes off JAX's by
    more than ``STEP_ATOL_OF_LR`` of its lr; per leaf, the relative norm distance of the
    Adam moments from JAX's (from the port's float32 step's for ``SUMMED_IN_BF16``, and
    there also JAX's own distance from it); the relative distance of the losses and
    ``Grads/*`` norms. ``python -m
    tests.torch_bf16_readings`` prints them for other seeds."""
    from sheeprl_tpu_torch.algos.dreamer_v3.params import parameter_list_from_jax, params_from_jax

    is_continuous = kind == "continuous"
    pair = build_train_pair(is_continuous, "bf16-mixed", seed=seed)
    modules = pair["modules"]
    assert modules["world_model"].rssm.recurrent_model.rnn.linear.compute_dtype == torch.bfloat16
    old = params_from_jax(pair["params"], modules)
    jout, (opt, _, metrics) = run_pair(pair, is_continuous, seed=seed + 3)
    new_jax = params_from_jax(jout[0], modules)
    algo = pair["cfg"].algo
    lr = {"world_model": algo.world_model.optimizer.lr, "actor": algo.actor.optimizer.lr, "critic": algo.critic.optimizer.lr}
    lr["target_critic"] = lr["critic"]
    out = {"off_share": {}, "mu": {}, "nu": {}, "metrics": {}}
    for name, module in modules.items():
        off = torch.cat([
            ((v.float() - old[name][k]) - (new_jax[name][k] - old[name][k])).abs().flatten() > STEP_ATOL_OF_LR * lr[name]
            for k, v in module.state_dict().items()
        ])
        out["off_share"][name] = off.float().mean().item()

    f32_opt = run_port(*build_port_step(pair["params"], is_continuous, "32-true", seed=seed)[1:3], is_continuous, seed + 3)[0]
    for name in ("world_model", "actor", "critic"):
        ref = _adam_state(jout[1][name])
        leaves = [k for k, _ in modules[name].named_parameters()]
        for moment in ("mu", "nu"):
            want = parameter_list_from_jax(getattr(ref, moment), modules[name], name)
            for leaf, got, exp, f32 in zip(leaves, opt[name][moment], want, f32_opt[name][moment]):
                if f"{name}.{leaf}" in SUMMED_IN_BF16:
                    out[f"jax_{moment}_off_f32"] = {f"{name}.{leaf}": ((exp - f32).norm() / f32.norm()).item()}
                    exp = f32
                err, norm = (got - exp).norm().item(), exp.norm().item()
                out[moment][f"{name}.{leaf}"] = err / norm if norm > 0 else (0.0 if err == 0 else float("inf"))
    for name in (*LOSSES, *GRADS):
        out["metrics"][name] = abs(metrics[name].item() - float(jout[3][name])) / abs(float(jout[3][name]))
    out["finite"] = all(np.isfinite(metrics[name].item()) for name in METRICS)
    return out


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_train_step_bf16_matches_jax_bf16(kind):
    """One whole step with the image and vector keys at bf16-mixed in both packages."""
    readings = train_step_readings(kind)
    for name, share in readings["off_share"].items():
        assert share <= MAX_OFF_SHARE, (name, share)
    for moment, rtol in (("mu", MU_RTOL), ("nu", NU_RTOL)):
        for leaf, rel in readings[moment].items():
            assert rel <= rtol, (leaf, moment, rel)
    for name, rel in readings["metrics"].items():
        assert rel <= METRIC_RTOL, (name, rel)
    assert readings["finite"]


@pytest.mark.parametrize(
    "name,dtype",
    [("bf16-mixed", torch.bfloat16), ("bf16", torch.bfloat16), ("32-true", torch.float32), ("32", torch.float32),
     ("fp32", torch.float32), ("f32", torch.float32), ("float32", torch.float32)],
)
def test_mesh_precision_names_match_the_reference(name, dtype):
    """The names the reference's ``MeshContext.compute_dtype`` maps to bfloat16 or
    float32 give the same dtype in the port."""
    from sheeprl_tpu.parallel.mesh import MeshContext, build_mesh
    from sheeprl_tpu_torch.parallel.context import compute_dtype

    ref = MeshContext(mesh=build_mesh(devices=jax.devices()[:1]), precision=name).compute_dtype
    assert compute_dtype(name) == dtype and str(np.dtype(ref)) == str(dtype).replace("torch.", "")


@pytest.mark.parametrize("name", ["bf16-true", "16-mixed", "fp16", "int8"])
def test_mesh_precision_the_port_lacks_raises(name):
    from sheeprl_tpu_torch.parallel.context import compute_dtype

    with pytest.raises((NotImplementedError, ValueError), match=name):
        compute_dtype(name)


def test_default_precision_is_bf16_mixed():
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.parallel.context import make_run_context

    cfg = compose(overrides=["exp=dreamer_v3_dummy", "env=discrete_dummy", "device=cpu"])
    assert cfg.mesh.precision == "bf16-mixed" and make_run_context(cfg).compute_dtype == torch.bfloat16
