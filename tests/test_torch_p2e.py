"""Plan2Explore's shared pieces of the PyTorch port (``sheeprl_tpu_torch/algos/p2e``)
against the JAX package's (``sheeprl_tpu/algos/p2e``), with N = 3 members.

The JAX package's stacked ensemble (``build_ensembles``, its parameters perturbed with
seeded noise) is carried into ``Ensembles`` by ``params_from_jax`` (stacked kernels
``[N, in, out]`` kept as they are); both are fed the same numpy inputs. Compared, in
float32: every member's predictions (``ensemble_apply``), the Gaussian ensemble loss
(``ensemble_loss_normal``) and its gradient, the disagreement reward
(``intrinsic_reward``, a population variance), atol = rtol = 1e-5 (outputs of order 1,
sums in other orders); and one step of the ensembles' optimizer (optax's chain from
``make_optimizer`` against the port's ``Optimizer``) from the same gradient, at
``weight_decay`` 1e-6 (the exp's) and 0.1, with the clip at the exp's 100 and at 0.1,
under the gradient's norm, so that the order of the decay and the clip shows: new
parameters atol 2e-6 and Adam moments at ``test_torch_dv2_train.py``'s limits.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_dv2_agent import perturbed
from tests.test_torch_dv3_train import F32, _adam_state

N, IN, OUT, DENSE, LAYERS = 3, 12, 6, 16, 2
TOL = dict(atol=1e-5, rtol=1e-5)


def build_pair(layer_norm: bool = False, seed: int = 0):
    """The JAX package's stacked ensemble (perturbed) and the port's holding it."""
    import jax
    import jax.numpy as jnp

    from sheeprl_tpu.algos.p2e import build_ensembles
    from sheeprl_tpu_torch.algos.dreamer_v3.params import module_state_from_jax
    from sheeprl_tpu_torch.algos.p2e import Ensembles

    mlp, stacked = build_ensembles(jax.random.PRNGKey(seed), N, IN, OUT, DENSE, LAYERS, "elu", layer_norm, jnp.float32)
    params = perturbed(stacked, seed + 1, 0.1)
    ens = Ensembles(N, IN, OUT, DENSE, LAYERS, "elu", layer_norm)
    ens.load_state_dict(module_state_from_jax(params["params"], ens, "ensembles"))
    return mlp, params, ens


def inputs(seed: int, *lead):
    return np.random.default_rng(seed).normal(size=(*lead, IN)).astype(np.float32)


def test_stacked_parameters_carry_and_init():
    """The stacked tree fills every entry of ``Ensembles`` (kernels ``[N, in, out]``,
    biases ``[N, out]``), and the port's own initialisation is Flax's default per member:
    truncated lecun-normal kernels that differ between members, zero biases."""
    from sheeprl_tpu_torch.algos.p2e import Ensembles

    _, params, ens = build_pair(layer_norm=True)
    shapes = {k: tuple(v.shape) for k, v in ens.state_dict().items()}
    assert shapes["dense.0.weight"] == (N, IN, DENSE) and shapes["dense.2.weight"] == (N, DENSE, OUT)
    assert shapes["dense.2.bias"] == (N, OUT) and shapes["norms.1.weight"] == (N, DENSE)
    np.testing.assert_array_equal(ens.dense[1].weight.detach().numpy(), np.asarray(params["params"]["Dense_1"]["kernel"]))
    fresh = Ensembles(N, IN, OUT, DENSE, LAYERS)
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    w = fresh.dense[0].weight
    assert not torch.equal(w[0], w[1]) and not fresh.dense[0].bias.any()
    std = np.sqrt(1.0 / IN)
    assert abs(w.std().item() - std) < 0.2 * std and w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6


@pytest.mark.parametrize("layer_norm", [False, True])
def test_ensemble_apply_matches_jax(layer_norm):
    import jax

    from sheeprl_tpu.algos.p2e import ensemble_apply

    mlp, params, ens = build_pair(layer_norm)
    x = inputs(1, 5, 4)
    ref = jax.jit(lambda p, x: ensemble_apply(mlp, p, x))(params, x)
    with torch.no_grad():
        out = ens(torch.from_numpy(x))
    assert tuple(out.shape) == tuple(ref.shape) == (N, 5, 4, OUT)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_ensemble_loss_normal_and_its_gradient_match_jax():
    import jax

    from sheeprl_tpu.algos.p2e import ensemble_loss_normal as jax_loss
    from sheeprl_tpu_torch.algos.dreamer_v3.params import parameter_list_from_jax
    from sheeprl_tpu_torch.algos.p2e import ensemble_loss_normal

    mlp, params, ens = build_pair()
    x, targets = inputs(2, 5, 4), np.random.default_rng(3).normal(size=(4, 4, OUT)).astype(np.float32)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jax_loss(mlp, p, x, targets)))(params)
    loss = ensemble_loss_normal(ens, torch.from_numpy(x), torch.from_numpy(targets))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    grads = torch.autograd.grad(loss, list(ens.parameters()))
    for got, want in zip(grads, parameter_list_from_jax(jax.device_get(jg), ens, "ensembles")):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_intrinsic_reward_matches_jax():
    """The members' population variance (``ddof`` 0, not torch's default 1), averaged over
    the features and scaled; no gradient reaches the inputs."""
    import jax

    from sheeprl_tpu.algos.p2e import intrinsic_reward as jax_reward
    from sheeprl_tpu_torch.algos.p2e import intrinsic_reward

    mlp, params, ens = build_pair()
    x = inputs(4, 3, 6)
    for mult in (1.0, 2.5):
        ref = jax.jit(lambda p, x: jax_reward(mlp, p, x, mult))(params, x)
        xt = torch.from_numpy(x).requires_grad_(True)
        out = intrinsic_reward(ens, xt, mult)
        assert tuple(out.shape) == (3, 6, 1)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
        out.sum().backward()
        assert xt.grad is None
    preds = ens(torch.from_numpy(x)).detach()
    assert not torch.allclose(out.detach(), preds.var(0).mean(-1, keepdim=True) * mult)  # the unbiased estimate differs


@pytest.mark.parametrize("weight_decay", [1e-6, 0.1])
@pytest.mark.parametrize("clip", [100.0, 0.1])
def test_ensemble_optimizer_matches_optax(weight_decay, clip):
    import jax
    import optax

    from sheeprl_tpu.algos.p2e import ensemble_loss_normal as jax_loss
    from sheeprl_tpu.algos.ppo.ppo import make_optimizer as jax_make_optimizer
    from sheeprl_tpu_torch.algos.dreamer_v3.params import module_state_from_jax, parameter_list_from_jax
    from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer

    opt_cfg = dict(name="adam", lr=3e-4, eps=1e-5, weight_decay=weight_decay, betas=[0.9, 0.999])
    mlp, params, ens = build_pair()
    x, targets = inputs(5, 5, 4), np.random.default_rng(6).normal(size=(4, 4, OUT)).astype(np.float32)
    jopt = jax_make_optimizer(opt_cfg, clip)
    state = jopt.init(params)
    grads = jax.grad(lambda p: jax_loss(mlp, p, x, targets))(params)
    assert float(optax.global_norm(grads)) > clip or clip == 100.0
    updates, new_state = jopt.update(grads, state, params)
    new_params = jax.device_get(optax.apply_updates(params, updates))

    opt = make_optimizer(opt_cfg, clip)
    plist = list(ens.parameters())
    ostate = opt.init(plist)
    tgrads = parameter_list_from_jax(jax.device_get(grads), ens, "ensembles")
    norm = opt.update(plist, tgrads, ostate)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-5)
    want = module_state_from_jax(new_params["params"], ens, "ensembles")
    for k, v in ens.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=F32["params"], rtol=0, err_msg=k)
    ref = _adam_state(jax.device_get(new_state))
    for moment in ("mu", "nu"):
        for got, exp in zip(ostate[moment], parameter_list_from_jax(getattr(ref, moment), ens, "ensembles")):
            torch.testing.assert_close(got, exp, rtol=F32["mom_rtol"], atol=F32["mom_atol_of_max"] * exp.abs().max().item())
