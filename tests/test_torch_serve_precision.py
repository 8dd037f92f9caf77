"""The serving path's precision pieces in the PyTorch port against the JAX package: int8
weight quantization, the parity metrics, the precision policies and the loss scales
(``quantize_params`` over whole agents is in ``test_torch_serve_act.py``, beside the
agents it builds).

Inputs come from numpy with a seed and go through both packages. Tolerances: ``q`` bit
for bit (both round half to even over the same float32 quotients), ``scale`` within
1e-7 relative (a float32 max over 127), dequantized weights within 1e-7; the parity
metrics within 1e-6 (float32 reductions); the loss scales exactly (powers of two).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

EXACTISH = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# --------------------------------------------------------------------------- quantize


@pytest.mark.parametrize("shape", [(7, 5), (64, 3), (1, 9), (300, 17)])
def test_quantize_weight_matches_jax(shape):
    from sheeprl_tpu.precision.quantize import quantize_weight as jax_quantize
    from sheeprl_tpu_torch.precision.quantize import quantize_weight

    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 3.0, (1, shape[1]))).astype(np.float32)  # Flax [in, out]
    w[:, 0] = 0.0  # an all-zero output channel: the smallest scale
    if shape[0] > 2 and shape[1] > 1:
        # a channel of scale 0.125 exactly (max 15.875) holding exact half steps: 2.5 and
        # 3.5 round to even, 2 and 4
        w[:, -1] = np.clip(w[:, -1], -15.0, 15.0)
        w[:3, -1] = (15.875, 0.3125, 0.4375)
    want = jax_quantize(jnp.asarray(w))
    got = quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))  # nn.Linear's [out, in]
    assert got.q.dtype == torch.int8 and got.scale.shape == (shape[1], 1)
    np.testing.assert_array_equal(got.q.numpy().T, np.asarray(want.q))
    np.testing.assert_allclose(got.scale.numpy()[:, 0], np.asarray(want.scale)[0], rtol=1e-7, atol=0)
    np.testing.assert_allclose(got.dequantize().numpy().T, np.asarray(want.dequantize()), rtol=1e-7, atol=0)


# --------------------------------------------------------------------------- parity metrics


def test_parity_metrics_match_jax():
    from sheeprl_tpu.precision import parity as jp
    from sheeprl_tpu_torch.precision import parity as tp

    rng = np.random.default_rng(3)
    a = rng.integers(0, 4, (50, 2)).astype(np.int32)
    b = a.copy()
    b[rng.random(50) < 0.3, 1] += 1
    ca = rng.standard_normal((50, 3)).astype(np.float32)
    cb = ca + rng.normal(0, 0.01, ca.shape).astype(np.float32)
    for x, y, cont in ((a, b, False), (ca, cb, True)):
        want = jp.action_agreement(x, y, continuous=cont)
        assert abs(tp.action_agreement(torch.from_numpy(x), torch.from_numpy(y), continuous=cont) - want) <= 1e-6
        np.testing.assert_array_equal(tp.action_agreement_mask(x, y, continuous=cont), np.asarray(jp.action_agreement_mask(x, y, continuous=cont)))
    pairs = ([a[:, 0], a[:, 1]], [b[:, 0], b[:, 1]])
    assert abs(tp.action_agreement(*pairs) - jp.action_agreement(*pairs)) <= 1e-6
    lp, lq = rng.standard_normal((40, 6)).astype(np.float32), rng.standard_normal((40, 6)).astype(np.float32)
    np.testing.assert_allclose(tp.categorical_kl(torch.from_numpy(lp), lq), jp.categorical_kl(lp, lq), **EXACTISH)
    log_std = rng.normal(-1, 0.5, ca.shape).astype(np.float32)
    np.testing.assert_allclose(tp.gaussian_mean_divergence(ca, cb), jp.gaussian_mean_divergence(ca, cb), **EXACTISH)
    np.testing.assert_allclose(tp.gaussian_mean_divergence(ca, torch.from_numpy(cb), log_std), jp.gaussian_mean_divergence(ca, cb, log_std), **EXACTISH)


# --------------------------------------------------------------------------- policies, loss scales


def test_resolve_policy_gives_the_references_dtype_triples():
    from sheeprl_tpu.precision.policy import _POLICIES
    from sheeprl_tpu.precision.policy import resolve_policy as jax_resolve
    from sheeprl_tpu_torch.precision import resolve_policy

    name = lambda d: str(d).removeprefix("torch.")  # noqa: E731
    for spec in _POLICIES:
        want, got = jax_resolve(spec), resolve_policy(spec)
        assert [name(got.param_dtype), name(got.compute_dtype), name(got.output_dtype)] == [
            jnp.dtype(want.param_dtype).name, jnp.dtype(want.compute_dtype).name, jnp.dtype(want.output_dtype).name], spec
        assert got.is_mixed == want.is_mixed and got.describe() == want.describe()
    cast = resolve_policy("bf16").cast_to_compute({"x": torch.ones(2), "n": torch.ones(2, dtype=torch.int32), "t": (torch.zeros(1),)})
    assert cast["x"].dtype == torch.bfloat16 and cast["n"].dtype == torch.int32 and cast["t"][0].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="Unknown precision spec"):
        resolve_policy("fp8")


def test_loss_scales_match_jax_over_a_seeded_run():
    from sheeprl_tpu.precision import loss_scale as jl
    from sheeprl_tpu_torch.precision import loss_scale as tl

    flags = np.random.default_rng(0).random(40) < 0.8
    jscale, tscale = jl.DynamicLossScale(scale=2.0**4, period=3, factor=2, min_scale=1.0), tl.DynamicLossScale(scale=2.0**4, period=3, factor=2, min_scale=1.0)
    for flag in flags:
        jscale, tscale = jscale.adjust(jnp.asarray(bool(flag))), tscale.adjust(torch.tensor(bool(flag)))
        assert float(tscale.loss_scale) == float(jscale.loss_scale) and int(tscale.counter) == int(jscale.counter)
    grads = {"a": np.linspace(-3, 3, 7).astype(np.float32), "b": [np.ones(3, np.float32)]}
    tgrads = {"a": torch.from_numpy(grads["a"]), "b": [torch.from_numpy(grads["b"][0])]}
    for js, ts in ((jl.StaticLossScale(8.0), tl.StaticLossScale(8.0)), (jscale, tscale), (jl.NoOpLossScale(), tl.NoOpLossScale())):
        np.testing.assert_array_equal(ts.scale(torch.tensor(1.5)).numpy(), np.asarray(js.scale(jnp.asarray(1.5))))
        np.testing.assert_array_equal(ts.unscale(tgrads)["a"].numpy(), np.asarray(js.unscale(grads)["a"]))
    bad = {"a": torch.tensor([1.0, float("inf")]), "n": torch.tensor([1])}
    assert bool(tl.all_finite(tgrads)) and not bool(tl.all_finite(bad)) and bool(tl.all_finite({}))
    assert bool(jl.all_finite(grads)) == bool(tl.all_finite(tgrads))
