"""Distributions as light containers over tensors (counterpart of
``sheeprl_tpu/distributions/__init__.py``).

Ported, for the DreamerV3 player, actor and losses: ``Categorical``,
``OneHotCategorical``, ``OneHotCategoricalStraightThrough`` and ``unimix_logits``; for
the continuous actor heads ``Normal``, ``TanhNormal`` and ``TruncatedNormal``; and
``Independent``, ``TwoHotEncodingDistribution``, ``SymlogDistribution``,
``MSEDistribution``, ``Bernoulli`` and ``BernoulliSafeMode``.

Randomness: the reference samples with JAX keys, whose draws torch cannot reproduce.
Every sampling method here takes an optional ``torch.Generator`` and, in its place, an
optional injected draw: ``noise`` (uniform in (0, 1) for the categoricals and the
truncated normal, standard normal for the normals), ``gumbel`` for the categoricals
(Gumbel noise of the logits' shape: the sample is ``argmax(logits + gumbel)``, which is
how ``jax.random.categorical`` draws, so a test can hand the port JAX's own noise) or,
for the one-hot categoricals, ``draw``, a one-hot sample used as it is. The parity tests
feed both packages the same draws that way.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.utils.utils import symexp, symlog, two_hot_encoder

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def _uniform(shape: Sequence[int], like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=generator, device=like.device, dtype=like.dtype)


def gumbel_noise(
    shape: Sequence[int], like: torch.Tensor, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in ``[tiny, 1)`` (``noise``
    when given), as ``jax.random.gumbel`` makes it."""
    if noise is None:
        noise = _uniform(shape, like, generator)
    tiny = torch.finfo(like.dtype).tiny
    return -torch.log(-torch.log(noise.clamp(tiny, 1.0)))


class Normal:
    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc = loc
        self.scale = scale

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return -((x - self.loc) ** 2) / (2 * self.scale**2) - torch.log(self.scale) - _HALF_LOG_2PI

    def sample(
        self, sample_shape: Sequence[int] = (), generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if noise is None:
            shape = (*sample_shape, *self.loc.shape)
            noise = torch.randn(shape, generator=generator, device=self.loc.device, dtype=self.loc.dtype)
        return self.loc + self.scale * noise

    def rsample(self, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.sample((), generator, noise)

    @property
    def mode(self) -> torch.Tensor:
        return self.loc

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    def entropy(self) -> torch.Tensor:
        return 0.5 + _HALF_LOG_2PI + torch.log(self.scale)


class TanhNormal:
    """tanh-squashed Gaussian with the change-of-variables log-prob."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
        self.base = Normal(loc, scale)
        self.eps = eps

    @staticmethod
    def _log_det(pre: torch.Tensor) -> torch.Tensor:
        return 2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre))

    def sample(
        self, sample_shape: Sequence[int] = (), generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return torch.tanh(self.base.sample(sample_shape, generator, noise))

    def rsample(self, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return torch.tanh(self.base.rsample(generator, noise))

    def sample_and_log_prob(
        self, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None
    ) -> tuple:
        """``(tanh(pre), log_prob)`` of one reparameterised draw ``pre``, the log-prob
        taken from ``pre`` itself (the SAC family's path), not from ``atanh`` of the
        clamped action as ``log_prob`` does: the two differ near ±1."""
        pre = self.base.rsample(generator, noise)
        return torch.tanh(pre), self.base.log_prob(pre) - self._log_det(pre)

    def log_prob(self, a: torch.Tensor) -> torch.Tensor:
        pre = torch.atanh(a.clamp(-1 + self.eps, 1 - self.eps))
        return self.base.log_prob(pre) - self._log_det(pre)

    @property
    def mode(self) -> torch.Tensor:
        return torch.tanh(self.base.loc)

    @property
    def mean(self) -> torch.Tensor:
        return torch.tanh(self.base.loc)

    def entropy(self) -> torch.Tensor:
        # delta-method approximation at the mean, as the reference does
        return self.base.entropy() + self._log_det(self.base.loc)


class TruncatedNormal:
    """Normal truncated to ``[low, high]``, sampled by the inverse CDF."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, low: float = -1.0, high: float = 1.0, eps: float = 1e-6):
        self.loc = loc
        self.scale = scale
        self.low = low
        self.high = high
        self.eps = eps

    def _clamp(self, x: torch.Tensor) -> torch.Tensor:
        clamped = x.clamp(self.low + self.eps, self.high - self.eps)
        return x + (clamped - x).detach()

    def _z(self):
        a = (self.low - self.loc) / self.scale
        b = (self.high - self.loc) / self.scale
        return a, b, torch.special.ndtr(b) - torch.special.ndtr(a)

    def sample(
        self, sample_shape: Sequence[int] = (), generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if noise is None:
            noise = _uniform((*sample_shape, *self.loc.shape), self.loc, generator) * (1 - 2e-5) + 1e-5
        a, _, z = self._z()
        p = torch.special.ndtr(a) + noise * z
        return self._clamp(self.loc + self.scale * torch.special.ndtri(p))

    def rsample(self, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.sample((), generator, noise)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        _, _, z = self._z()
        return Normal(self.loc, self.scale).log_prob(x) - torch.log(z + 1e-8)

    @property
    def mode(self) -> torch.Tensor:
        return self.loc.clamp(self.low, self.high)

    @property
    def mean(self) -> torch.Tensor:
        return self.mode

    def entropy(self) -> torch.Tensor:
        a, b, z = self._z()
        pdf = lambda v: torch.exp(-0.5 * v**2) / math.sqrt(2 * math.pi)  # noqa: E731
        z = z.clamp_min(1e-8)
        return 0.5 + _HALF_LOG_2PI + torch.log(self.scale) + torch.log(z) + (a * pdf(a) - b * pdf(b)) / (2 * z)


class Categorical:
    def __init__(self, logits: torch.Tensor):
        self.logits = torch.log_softmax(logits, dim=-1)

    @property
    def probs(self) -> torch.Tensor:
        return torch.exp(self.logits)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return torch.take_along_dim(self.logits, x.long()[..., None], dim=-1)[..., 0]

    def sample(
        self,
        sample_shape: Sequence[int] = (),
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        gumbel: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Gumbel-max over ``logits + gumbel``; ``gumbel`` (shape ``sample_shape +
        logits.shape``) is made from ``noise``, uniform in (0, 1), when not given."""
        if gumbel is None:
            gumbel = gumbel_noise((*sample_shape, *self.logits.shape), self.logits, generator, noise)
        return torch.argmax(self.logits + gumbel, dim=-1)

    @property
    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)

    def entropy(self) -> torch.Tensor:
        return -(self.probs * self.logits).sum(-1)


class OneHotCategorical(Categorical):
    def sample(
        self,
        sample_shape: Sequence[int] = (),
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        draw: Optional[torch.Tensor] = None,
        gumbel: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """A one-hot sample; ``draw`` (one-hot, ``sample_shape + logits.shape``) is
        returned as the sample when given."""
        if draw is not None:
            return draw.to(self.logits.dtype)
        idx = super().sample(sample_shape, generator, noise, gumbel)
        return F.one_hot(idx, self.logits.shape[-1]).to(self.logits.dtype)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return (self.logits * x).sum(-1)

    @property
    def mode(self) -> torch.Tensor:
        return F.one_hot(torch.argmax(self.logits, dim=-1), self.logits.shape[-1]).to(self.logits.dtype)


class OneHotCategoricalStraightThrough(OneHotCategorical):
    """One-hot forward, ``probs`` gradient backward: ``sample + probs - probs.detach()``
    (reference ``distributions/__init__.py:262-268``)."""

    def rsample(
        self,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        draw: Optional[torch.Tensor] = None,
        gumbel: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        hard = self.sample((), generator, noise, draw, gumbel)
        probs = self.probs
        return hard + probs - probs.detach()


def unimix_logits(logits: torch.Tensor, unimix: float = 0.01) -> torch.Tensor:
    """Mix ``unimix`` uniform probability into the categorical (DreamerV3)."""
    if unimix <= 0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    probs = (1 - unimix) * probs + unimix / probs.shape[-1]
    return torch.log(probs)


class Independent:
    """Sum log-probs and entropies over the trailing ``reinterpreted_batch_ndims`` dims."""

    def __init__(self, base, reinterpreted_batch_ndims: int = 1):
        self.base = base
        self.ndims = reinterpreted_batch_ndims

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self.ndims == 0:
            return x
        return x.sum(dim=tuple(range(-self.ndims, 0)))

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(self.base.log_prob(x))

    @property
    def mode(self) -> torch.Tensor:
        return self.base.mode

    @property
    def mean(self) -> torch.Tensor:
        return self.base.mean

    def entropy(self) -> torch.Tensor:
        return self._reduce(self.base.entropy())


class TwoHotEncodingDistribution:
    """Symlog-space two-hot distribution over ``bins`` evenly spaced values in
    ``[low, high]``; ``logits`` ``[..., bins]``. The mean decodes with ``symexp``."""

    def __init__(self, logits: torch.Tensor, dims: int = 0, low: float = -20.0, high: float = 20.0):
        self.logits = torch.log_softmax(logits, dim=-1)
        self.dims = dims
        self.low = low
        self.high = high
        self.bins = logits.shape[-1]

    @property
    def mean(self) -> torch.Tensor:
        support = torch.linspace(self.low, self.high, self.bins, dtype=self.logits.dtype, device=self.logits.device)
        return symexp((self.logits.exp() * support).sum(-1, keepdim=True))

    @property
    def mode(self) -> torch.Tensor:
        return self.mean

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: ``[..., 1]`` raw-space scalars."""
        target = two_hot_encoder(symlog(x), support_range=int(self.high), num_buckets=self.bins)
        lp = (target * self.logits).sum(-1, keepdim=True)
        if self.dims:
            lp = lp.sum(dim=tuple(range(-self.dims, 0)))
        return lp


class _SquaredError:
    """``-(loc - target)^2`` as a log-prob, summed (or averaged) over ``dims`` trailing dims."""

    def __init__(self, loc: torch.Tensor, dims: int = 1, agg: str = "sum"):
        self.loc = loc
        self.dims = dims
        self.agg = agg

    def _target(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        dist = -((self.loc - self._target(x)) ** 2)
        if self.dims == 0:
            return dist
        dims = tuple(range(-self.dims, 0))
        return dist.sum(dims) if self.agg == "sum" else dist.mean(dims)


class SymlogDistribution(_SquaredError):
    """-MSE in symlog space as a log-prob; the mode is ``symexp(loc)``."""

    def _target(self, x: torch.Tensor) -> torch.Tensor:
        return symlog(x)

    @property
    def mode(self) -> torch.Tensor:
        return symexp(self.loc)

    @property
    def mean(self) -> torch.Tensor:
        return symexp(self.loc)


class MSEDistribution(_SquaredError):
    @property
    def mode(self) -> torch.Tensor:
        return self.loc

    @property
    def mean(self) -> torch.Tensor:
        return self.loc


class Bernoulli:
    def __init__(self, logits: torch.Tensor):
        self.logits = logits

    @property
    def probs(self) -> torch.Tensor:
        return torch.sigmoid(self.logits)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return -self.logits.clamp_min(0) + self.logits * x - torch.log1p(torch.exp(-self.logits.abs()))

    def sample(
        self, sample_shape: Sequence[int] = (), generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if noise is None:
            noise = _uniform((*sample_shape, *self.logits.shape), self.logits, generator)
        return (noise < self.probs).to(self.logits.dtype)

    def entropy(self) -> torch.Tensor:
        p = self.probs
        return -(p * torch.log(p + 1e-8) + (1 - p) * torch.log(1 - p + 1e-8))


class BernoulliSafeMode(Bernoulli):
    """Bernoulli whose mode is ``probs > 0.5`` (never NaN at p = 0.5)."""

    @property
    def mode(self) -> torch.Tensor:
        return (self.probs > 0.5).to(self.logits.dtype)
