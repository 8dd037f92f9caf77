"""The distributions of the DreamerV3 losses in the PyTorch port against the JAX
package: values, log-probs, entropies and means on the same seeded numpy inputs, and
categorical draws made from JAX's own Gumbel noise equal to ``jax.random.categorical``.

Tolerance: atol = rtol = 1e-5 in float32 (the same formulas, summed in other orders);
draws must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sheeprl_tpu.distributions as jd
import sheeprl_tpu_torch.distributions as td
from sheeprl_tpu.utils import utils as jutils
from sheeprl_tpu_torch.utils import utils as tutils

TOL = dict(atol=1e-5, rtol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def close(t, j, **kw):
    np.testing.assert_allclose(np.asarray(t.detach() if isinstance(t, torch.Tensor) else t), np.asarray(j), **(kw or TOL))


@pytest.mark.parametrize("bins,support", [(255, 20), (15, 20), (41, 300)])
def test_two_hot_encoder_and_decoder(bins, support):
    x = _rng(0).normal(0, support / 2, size=(64, 1)).astype(np.float32)
    x[:3, 0] = [-support * 2, support * 2, 0.0]
    enc_t = tutils.two_hot_encoder(torch.from_numpy(x), support, bins)
    close(enc_t, jutils.two_hot_encoder(jnp.asarray(x), support, bins))
    close(tutils.two_hot_decoder(enc_t, support), jutils.two_hot_decoder(jnp.asarray(np.asarray(enc_t)), support))


def test_two_hot_distribution():
    logits = _rng(1).normal(size=(3, 5, 255)).astype(np.float32)
    x = _rng(2).normal(0, 30, size=(3, 5, 1)).astype(np.float32)
    t, j = td.TwoHotEncodingDistribution(torch.from_numpy(logits), dims=1), jd.TwoHotEncodingDistribution(jnp.asarray(logits), dims=1)
    close(t.mean, j.mean, atol=1e-4, rtol=1e-5)
    close(t.log_prob(torch.from_numpy(x)), j.log_prob(jnp.asarray(x)))


@pytest.mark.parametrize("cls,dims", [("SymlogDistribution", 1), ("MSEDistribution", 3), ("MSEDistribution", 0)])
def test_squared_error_distributions(cls, dims):
    loc = _rng(3).normal(size=(4, 2, 3, 5, 5)).astype(np.float32)
    x = _rng(4).normal(0, 5, size=loc.shape).astype(np.float32)
    t, j = getattr(td, cls)(torch.from_numpy(loc), dims=dims), getattr(jd, cls)(jnp.asarray(loc), dims=dims)
    close(t.log_prob(torch.from_numpy(x)), j.log_prob(jnp.asarray(x)))
    close(t.mode, j.mode)
    close(t.mean, j.mean)


def test_bernoulli_safe_mode_and_independent():
    logits = _rng(5).normal(0, 3, size=(6, 4, 1)).astype(np.float32)
    logits[0, 0, 0] = 0.0  # p = 0.5: the safe mode is 0
    x = (_rng(6).random(size=logits.shape) < 0.5).astype(np.float32)
    t, j = td.BernoulliSafeMode(torch.from_numpy(logits)), jd.BernoulliSafeMode(jnp.asarray(logits))
    close(t.log_prob(torch.from_numpy(x)), j.log_prob(jnp.asarray(x)))
    close(t.entropy(), j.entropy())
    np.testing.assert_array_equal(t.mode.numpy(), np.asarray(j.mode))
    ti, ji = td.Independent(t, 1), jd.Independent(j, 1)
    close(ti.log_prob(torch.from_numpy(x)), ji.log_prob(jnp.asarray(x)))
    close(ti.entropy(), ji.entropy())


def test_independent_one_hot_entropy():
    logits = _rng(7).normal(size=(5, 3, 4, 8)).astype(np.float32)
    t = td.Independent(td.OneHotCategorical(torch.from_numpy(logits)), 1)
    j = jd.Independent(jd.OneHotCategorical(jnp.asarray(logits)), 1)
    close(t.entropy(), j.entropy())


@pytest.mark.parametrize("shape", [(16, 4, 8), (32, 3), (2, 5, 32, 32)])
def test_gumbel_draws_equal_jax_categorical(shape):
    """``jax.random.categorical`` is ``argmax(logits + gumbel(key))``: the port's
    categoricals, handed ``jax.random.gumbel(key)``, draw what JAX draws."""
    logits = _rng(8).normal(size=shape).astype(np.float32)
    key = jax.random.PRNGKey(sum(shape))
    jidx = np.asarray(jax.random.categorical(key, jnp.asarray(logits), axis=-1))
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(key, shape)))
    tidx = td.Categorical(torch.from_numpy(logits)).sample(gumbel=gumbel)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    jone = np.asarray(jd.OneHotCategoricalStraightThrough(jnp.asarray(logits)).rsample(key))
    tone = td.OneHotCategoricalStraightThrough(torch.from_numpy(logits)).rsample(gumbel=gumbel)
    # forward value of the straight-through sample: the one-hot, up to the rounding of
    # hard + probs - probs
    np.testing.assert_allclose(tone.numpy(), jone, atol=1e-6)
    np.testing.assert_array_equal(tone.numpy().argmax(-1), jidx)
