"""Continuous families of the port (PyTorch port of
``odin_tpu/bay/distributions/continuous.py``): ``Normal`` :72,
``LogNormal`` :119, ``Logistic`` :148, ``Uniform`` :188, ``Laplace`` :222,
``Gamma`` :253, ``Beta`` :299, ``Dirichlet`` :346, ``MultivariateNormalDiag``
:402, ``MultivariateNormalTriL`` :455, ``NormalGamma`` :536 and
``LogUniform`` :578, with JAX's registered KLs.

The Gamma-based draws (``Gamma``, ``Beta``, ``NormalGamma``) take JAX's
draws in its order from a ``training.core.Noise`` (``sampling.gamma_draws``:
8 rounds of a normal and a uniform, then the boost's uniform) and are
differentiable along the accepted proposal's path
(``sampling.log_gamma_pathwise``), as JAX differentiates its
``_sample_gamma``.  ``sample(generator=...)`` draws the same way from a
generator.

The Dirichlet draws its Gammas from a ``training.core.Noise`` in the JAX
package's order, with JAX's fixed rounds, fallback and pathwise gradient
(``sampling.gamma_draws``, ``sampling.log_gamma_pathwise``), and forms
the sample as ``softmax(log g)`` where JAX forms ``g / sum(g)``: the same
numbers wherever JAX's boosted Gammas do not underflow.  Where they do
(small concentrations), JAX's rows hold exact zeros or are NaN, and the
port's stay on the open simplex: a component is never below the smallest
float32 subnormal, so ``log_prob`` of a sample is finite.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from odin_tpu_torch.bay.distributions.base import Distribution, register_kl

__all__ = ["Normal", "LogNormal", "Logistic", "Uniform", "Laplace", "Gamma",
           "Beta", "Dirichlet", "MultivariateNormalDiag",
           "MultivariateNormalTriL", "NormalGamma", "LogUniform"]

_LOG2PI = math.log(2.0 * math.pi)
_SUBNORMAL = 2.0 ** -149  # the smallest positive float32


def _noise(shape, like: torch.Tensor, generator, eps):
  if eps is None:
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)
  eps = torch.as_tensor(eps, dtype=like.dtype, device=like.device)
  if tuple(eps.shape) != tuple(shape):
    raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {tuple(shape)}")
  return eps


class Normal(Distribution):
  _params = ("loc", "scale")

  def __init__(self, loc, scale):
    self.loc = torch.as_tensor(loc)
    self.scale = torch.as_tensor(scale)

  @property
  def batch_shape(self):
    return torch.broadcast_shapes(self.loc.shape, self.scale.shape)

  def sample(self, sample_shape=(), generator=None, eps=None):
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    return self.loc + self.scale * _noise(shape, self.loc, generator, eps)

  def log_prob(self, x):
    z = (x - self.loc) / self.scale
    return -0.5 * (z * z + _LOG2PI) - torch.log(self.scale)

  def mean(self):
    return self.loc.expand(self.batch_shape)

  def mode(self):
    return self.mean()

  def variance(self):
    return (self.scale * self.scale).expand(self.batch_shape)

  def stddev(self):
    return self.scale.expand(self.batch_shape)

  def entropy(self):
    return (0.5 * (1.0 + _LOG2PI) + torch.log(self.scale)).expand(
        self.batch_shape)

  def cdf(self, x):
    return 0.5 * (1.0 + torch.erf((x - self.loc) /
                                  (self.scale * math.sqrt(2.0))))


@register_kl(Normal, Normal)
def _kl_normal(q: Normal, p: Normal):
  var_ratio = (q.scale / p.scale) ** 2
  t = ((q.loc - p.loc) / p.scale) ** 2
  return 0.5 * (var_ratio + t - 1.0 - torch.log(var_ratio))


class MultivariateNormalDiag(Distribution):
  _params = ("loc", "scale_diag")

  def __init__(self, loc, scale_diag):
    self.loc = torch.as_tensor(loc)
    self.scale_diag = torch.as_tensor(scale_diag)

  @property
  def _shape(self):
    return torch.broadcast_shapes(self.loc.shape, self.scale_diag.shape)

  @property
  def batch_shape(self):
    return self._shape[:-1]

  @property
  def event_shape(self):
    return self._shape[-1:]

  def sample(self, sample_shape=(), generator=None, eps=None):
    shape = tuple(sample_shape) + tuple(self._shape)
    return self.loc + self.scale_diag * _noise(shape, self.loc, generator, eps)

  def log_prob(self, x):
    z = (x - self.loc) / self.scale_diag
    d = self.event_shape[0]
    return (-0.5 * torch.sum(z * z, dim=-1)
            - torch.sum(torch.log(self.scale_diag) * torch.ones_like(z), dim=-1)
            - 0.5 * d * _LOG2PI)

  def mean(self):
    return self.loc.expand(self._shape)

  def mode(self):
    return self.mean()

  def variance(self):
    return (self.scale_diag ** 2).expand(self._shape)

  def stddev(self):
    return self.scale_diag.expand(self._shape)

  def entropy(self):
    d = self.event_shape[0]
    return (0.5 * d * (1.0 + _LOG2PI) +
            torch.sum(torch.log(self.scale_diag).expand(self._shape), dim=-1))


@register_kl(MultivariateNormalDiag, MultivariateNormalDiag)
def _kl_mvndiag(q, p):
  var_ratio = (q.scale_diag / p.scale_diag) ** 2
  t = ((q.loc - p.loc) / p.scale_diag) ** 2
  return 0.5 * torch.sum(var_ratio + t - 1.0 - torch.log(var_ratio), dim=-1)


def _uniforms(shape, like: torch.Tensor, generator, eps, tiny: bool):
  """Uniforms in [0, 1) (in [tiny, 1) with `tiny`, as JAX's
  ``uniform(minval=finfo.tiny)`` draws them), or the given `eps`."""
  if eps is None:
    u = torch.rand(shape, generator=generator, dtype=like.dtype,
                   device=like.device)
    return torch.clamp(u, min=torch.finfo(like.dtype).tiny) if tiny else u
  eps = torch.as_tensor(eps, dtype=like.dtype, device=like.device)
  if tuple(eps.shape) != tuple(shape):
    raise ValueError(f"eps has shape {tuple(eps.shape)}, expected "
                     f"{tuple(shape)}")
  return eps


def _float(x) -> torch.Tensor:
  x = torch.as_tensor(x)
  return x if x.is_floating_point() else x.to(torch.float32)


class Logistic(Distribution):
  """Logistic(loc, scale); a sample is ``loc + scale * logit(u)`` of a
  uniform u in [tiny, 1), the noise `eps` is u."""
  _params = ("loc", "scale")

  def __init__(self, loc, scale):
    self.loc = _float(loc)
    self.scale = _float(scale)

  @property
  def batch_shape(self):
    return torch.broadcast_shapes(self.loc.shape, self.scale.shape)

  def sample(self, sample_shape=(), generator=None, eps=None):
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    u = _uniforms(shape, self.loc, generator, eps, tiny=True)
    return self.loc + self.scale * (torch.log(u) - torch.log1p(-u))

  def sample_from(self, noise, sample_shape=()):
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    u = noise.uniform(shape, self.loc.dtype, self.loc.device)
    return self.sample(sample_shape,
                       eps=torch.clamp(u, min=torch.finfo(u.dtype).tiny))

  def log_prob(self, x):
    z = (x - self.loc) / self.scale
    return -z - 2.0 * F.softplus(-z) - torch.log(self.scale)

  def cdf(self, x):
    return torch.sigmoid((x - self.loc) / self.scale)

  def log_cdf(self, x):
    return -F.softplus(-(x - self.loc) / self.scale)

  def mean(self):
    return self.loc.expand(self.batch_shape)

  def mode(self):
    return self.mean()

  def variance(self):
    return ((self.scale * math.pi) ** 2 / 3.0).expand(self.batch_shape)

  def entropy(self):
    return (torch.log(self.scale) + 2.0).expand(self.batch_shape)


class Uniform(Distribution):
  """Uniform on [low, high]; a sample is ``low + (high - low) * u``, the
  noise `eps` is u."""
  _params = ("low", "high")

  def __init__(self, low=0.0, high=1.0):
    self.low = _float(low)
    self.high = _float(high)

  @property
  def batch_shape(self):
    return torch.broadcast_shapes(self.low.shape, self.high.shape)

  def sample(self, sample_shape=(), generator=None, eps=None):
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    width = self.high - self.low
    return self.low + width * _uniforms(shape, width, generator, eps,
                                        tiny=False)

  def sample_from(self, noise, sample_shape=()):
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    return self.sample(sample_shape, eps=noise.uniform(
        shape, self.dtype, self.low.device))

  def log_prob(self, x):
    inside = (x >= self.low) & (x <= self.high)
    lp = -torch.log(self.high - self.low)
    return torch.where(inside, lp, torch.full_like(lp, -math.inf))

  def cdf(self, x):
    return torch.clamp((x - self.low) / (self.high - self.low), 0.0, 1.0)

  def log_cdf(self, x):
    return torch.log(self.cdf(x))

  def mean(self):
    return (0.5 * (self.low + self.high)).expand(self.batch_shape)

  def variance(self):
    return ((self.high - self.low) ** 2 / 12.0).expand(self.batch_shape)

  def entropy(self):
    return torch.log(self.high - self.low).expand(self.batch_shape)


class Dirichlet(Distribution):
  _params = ("concentration",)

  def __init__(self, concentration):
    self.concentration = torch.as_tensor(concentration)

  @property
  def batch_shape(self):
    return tuple(self.concentration.shape[:-1])

  @property
  def event_shape(self):
    return tuple(self.concentration.shape[-1:])

  def sample_from(self, noise, sample_shape=()):
    """A sample from the Gamma draws `noise` hands out (``gamma_draws``),
    differentiable in the concentration."""
    from odin_tpu_torch.bay.distributions.sampling import (
        gamma_draws, log_gamma_pathwise)
    a = self.concentration
    shape = tuple(sample_shape) + tuple(a.shape)
    x, u, u_boost = gamma_draws(noise, shape, a.dtype, a.device)
    log_g = log_gamma_pathwise(a.expand(shape), x, u, u_boost)
    return torch.clamp(torch.softmax(log_g, dim=-1), min=_SUBNORMAL)

  def sample(self, sample_shape=(), generator=None, eps=None):
    """A sample drawn from `generator`, or from `eps`, the list of draws
    ``sample_from`` makes (JAX's, in its order)."""
    from odin_tpu_torch.bay.distributions.spherical import _noise
    return self.sample_from(_noise(generator, eps, self.concentration.device),
                            sample_shape)

  def log_prob(self, x):
    a = self.concentration
    return (torch.sum((a - 1.0) * torch.log(x), dim=-1) +
            torch.lgamma(torch.sum(a, dim=-1)) -
            torch.sum(torch.lgamma(a), dim=-1))

  def mean(self):
    return self.concentration / torch.sum(self.concentration, dim=-1,
                                          keepdim=True)

  def mode(self):
    a = self.concentration
    a0 = torch.sum(a, dim=-1, keepdim=True)
    return (a - 1.0) / (a0 - a.shape[-1])

  def variance(self):
    a = self.concentration
    m = a / torch.sum(a, dim=-1, keepdim=True)
    return m * (1.0 - m) / (torch.sum(a, dim=-1, keepdim=True) + 1.0)

  def entropy(self):
    a = self.concentration
    a0 = torch.sum(a, dim=-1)
    k = a.shape[-1]
    return (torch.sum(torch.lgamma(a), dim=-1) - torch.lgamma(a0) +
            (a0 - k) * torch.digamma(a0) -
            torch.sum((a - 1.0) * torch.digamma(a), dim=-1))


@register_kl(Dirichlet, Dirichlet)
def _kl_dirichlet(q: Dirichlet, p: Dirichlet):
  a, b = q.concentration, p.concentration
  a0 = torch.sum(a, dim=-1, keepdim=True)
  return (torch.lgamma(torch.sum(a, dim=-1)) -
          torch.lgamma(torch.sum(b, dim=-1)) -
          torch.sum(torch.lgamma(a), dim=-1) +
          torch.sum(torch.lgamma(b), dim=-1) +
          torch.sum((a - b) * (torch.digamma(a) - torch.digamma(a0)), dim=-1))


def _draws(generator, eps, device):
  """The ``Noise`` a family with non-normal draws samples from: `eps` (the
  list of draws ``sample_from`` makes) or `generator`."""
  from odin_tpu_torch.bay.distributions.spherical import _noise
  return _noise(generator, eps, device)


def _log_gamma(noise, alpha: torch.Tensor, shape) -> torch.Tensor:
  """log Gamma(alpha, 1) of `shape` from JAX's draws in its order,
  differentiable in alpha (``_sample_gamma``, ``continuous.py:32``)."""
  from odin_tpu_torch.bay.distributions.sampling import (gamma_draws,
                                                         log_gamma_pathwise)
  x, u, u_boost = gamma_draws(noise, shape, alpha.dtype, alpha.device)
  return log_gamma_pathwise(alpha.expand(shape), x, u, u_boost,
                            kind="gamma_family")


class LogNormal(Normal):
  """exp(Normal(loc, scale)); ``log_prob`` includes the 1/x Jacobian.
  ``stddev`` and ``cdf`` are the log-normal's own (the JAX package's
  class inherits the Normal's, which give the scale and the cdf of x under
  Normal(loc, scale))."""

  def sample(self, sample_shape=(), generator=None, eps=None):
    return torch.exp(super().sample(sample_shape, generator, eps))

  def log_prob(self, x):
    logx = torch.log(x)
    return super().log_prob(logx) - logx

  def mean(self):
    return torch.exp(self.loc + 0.5 * self.scale ** 2).expand(
        self.batch_shape)

  def mode(self):
    return torch.exp(self.loc - self.scale ** 2).expand(self.batch_shape)

  def variance(self):
    s2 = self.scale ** 2
    return ((torch.exp(s2) - 1.0) * torch.exp(2.0 * self.loc + s2)).expand(
        self.batch_shape)

  def stddev(self):
    return torch.sqrt(self.variance())

  def entropy(self):
    return super().entropy() + self.loc

  def cdf(self, x):
    return super().cdf(torch.log(x))


@register_kl(LogNormal, LogNormal)
def _kl_lognormal(q, p):
  return _kl_normal(q, p)  # invariant under the shared exp bijector


class Laplace(Distribution):
  """Laplace(loc, scale); a sample is ``loc + scale sign(u) log1p(-|u|)``
  of a uniform u in (-1, 1), as ``jax.random.laplace`` forms it; the noise
  `eps` is u."""
  _params = ("loc", "scale")

  def __init__(self, loc, scale):
    self.loc = _float(loc)
    self.scale = _float(scale)

  @property
  def batch_shape(self):
    return torch.broadcast_shapes(self.loc.shape, self.scale.shape)

  def sample(self, sample_shape=(), generator=None, eps=None):
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    if eps is None:
      eps = 2.0 * _uniforms(shape, self.loc, generator, None, tiny=False) - 1.0
    u = torch.clamp(torch.as_tensor(eps, dtype=self.loc.dtype,
                                    device=self.loc.device),
                    min=-1.0 + 0.5 * torch.finfo(self.loc.dtype).eps)
    return self.loc + self.scale * torch.sign(u) * torch.log1p(-torch.abs(u))

  def sample_from(self, noise, sample_shape=()):
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    return self.sample(sample_shape, eps=2.0 * noise.uniform(
        shape, self.loc.dtype, self.loc.device) - 1.0)

  def log_prob(self, x):
    return -torch.abs(x - self.loc) / self.scale - torch.log(2.0 * self.scale)

  def mean(self):
    return self.loc.expand(self.batch_shape)

  def mode(self):
    return self.mean()

  def variance(self):
    return (2.0 * self.scale ** 2).expand(self.batch_shape)

  def entropy(self):
    return (torch.log(2.0 * self.scale) + 1.0).expand(self.batch_shape)


class Gamma(Distribution):
  """Gamma(concentration, rate); a sample is ``Gamma(concentration, 1) /
  rate`` from JAX's draws (``_log_gamma``), differentiable in both."""
  _params = ("concentration", "rate")

  def __init__(self, concentration, rate):
    self.concentration = _float(concentration)
    self.rate = _float(rate)

  @property
  def batch_shape(self):
    return torch.broadcast_shapes(self.concentration.shape, self.rate.shape)

  def sample_from(self, noise, sample_shape=()):
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    return torch.exp(_log_gamma(noise, self.concentration, shape)) / self.rate

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self.sample_from(_draws(generator, eps,
                                   self.concentration.device), sample_shape)

  def log_prob(self, x):
    a, b = self.concentration, self.rate
    return (a * torch.log(b) - torch.lgamma(a) + (a - 1.0) * torch.log(x)
            - b * x)

  def mean(self):
    return (self.concentration / self.rate).expand(self.batch_shape)

  def mode(self):
    return (torch.clamp(self.concentration - 1.0, min=0.0) /
            self.rate).expand(self.batch_shape)

  def variance(self):
    return (self.concentration / self.rate ** 2).expand(self.batch_shape)

  def entropy(self):
    a, b = self.concentration, self.rate
    return (a - torch.log(b) + torch.lgamma(a) +
            (1.0 - a) * torch.digamma(a)).expand(self.batch_shape)


@register_kl(Gamma, Gamma)
def _kl_gamma(q: Gamma, p: Gamma):
  a1, b1 = q.concentration, q.rate
  a2, b2 = p.concentration, p.rate
  return ((a1 - a2) * torch.digamma(a1) - torch.lgamma(a1) +
          torch.lgamma(a2) + a2 * (torch.log(b1) - torch.log(b2)) +
          a1 * (b2 / b1 - 1.0))


def _betaln(a, b):
  return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


class Beta(Distribution):
  """Beta(concentration1, concentration0); a sample is ``X / (X + Y)`` of
  Gammas drawn as JAX draws them (X's draws, then Y's), formed from their
  logs."""
  _params = ("concentration1", "concentration0")

  def __init__(self, concentration1, concentration0):
    self.concentration1 = _float(concentration1)  # alpha
    self.concentration0 = _float(concentration0)  # beta

  @property
  def batch_shape(self):
    return torch.broadcast_shapes(self.concentration1.shape,
                                  self.concentration0.shape)

  def sample_from(self, noise, sample_shape=()):
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    log_a = _log_gamma(noise, self.concentration1, shape)
    log_b = _log_gamma(noise, self.concentration0, shape)
    return torch.sigmoid(log_a - log_b)

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self.sample_from(_draws(generator, eps,
                                   self.concentration1.device), sample_shape)

  def log_prob(self, x):
    a, b = self.concentration1, self.concentration0
    return ((a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x) -
            _betaln(a, b))

  def mean(self):
    a, b = self.concentration1, self.concentration0
    return (a / (a + b)).expand(self.batch_shape)

  def mode(self):
    a, b = self.concentration1, self.concentration0
    return ((a - 1.0) / (a + b - 2.0)).expand(self.batch_shape)

  def variance(self):
    a, b = self.concentration1, self.concentration0
    t = a + b
    return (a * b / (t * t * (t + 1.0))).expand(self.batch_shape)


@register_kl(Beta, Beta)
def _kl_beta(q: Beta, p: Beta):
  a1, b1 = q.concentration1, q.concentration0
  a2, b2 = p.concentration1, p.concentration0
  t1 = a1 + b1
  return (_betaln(a2, b2) - _betaln(a1, b1) +
          (a1 - a2) * torch.digamma(a1) + (b1 - b2) * torch.digamma(b1) +
          (a2 - a1 + b2 - b1) * torch.digamma(t1))


def _tril_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """``L^-1 b`` for lower-triangular L, broadcast over the batch dims."""
  shape = torch.broadcast_shapes(L.shape[:-2], b.shape[:-2])
  return torch.linalg.solve_triangular(
      L.expand(tuple(shape) + tuple(L.shape[-2:])),
      b.expand(tuple(shape) + tuple(b.shape[-2:])), upper=False)


def _half_logdet(L: torch.Tensor) -> torch.Tensor:
  return torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


class MultivariateNormalTriL(Distribution):
  """N(loc, L Lᵀ) for a lower-triangular `scale_tril` L with a positive
  diagonal; a sample is ``loc + L eps``."""
  _params = ("loc", "scale_tril")

  def __init__(self, loc, scale_tril):
    self.loc = torch.as_tensor(loc)
    self.scale_tril = torch.as_tensor(scale_tril)

  @property
  def batch_shape(self):
    return tuple(self.scale_tril.shape[:-2])

  @property
  def event_shape(self):
    return tuple(self.scale_tril.shape[-1:])

  def sample(self, sample_shape=(), generator=None, eps=None):
    shape = tuple(sample_shape) + self.batch_shape + self.event_shape
    e = _noise(shape, self.loc, generator, eps)
    return self.loc + torch.einsum("...ij,...j->...i", self.scale_tril, e)

  def log_prob(self, x):
    d = self.event_shape[0]
    z = _tril_solve(self.scale_tril, (x - self.loc)[..., None])[..., 0]
    return (-0.5 * torch.sum(z * z, dim=-1) - _half_logdet(self.scale_tril)
            - 0.5 * d * _LOG2PI)

  def covariance(self):
    return torch.einsum("...ij,...kj->...ik", self.scale_tril,
                        self.scale_tril)

  def mean(self):
    return self.loc.expand(self.batch_shape + self.event_shape)

  def mode(self):
    return self.mean()

  def variance(self):
    return torch.diagonal(self.covariance(), dim1=-2, dim2=-1)

  def entropy(self):
    d = self.event_shape[0]
    return 0.5 * d * (1.0 + _LOG2PI) + _half_logdet(self.scale_tril)


@register_kl(MultivariateNormalTriL, MultivariateNormalTriL)
def _kl_mvntril(q: MultivariateNormalTriL, p: MultivariateNormalTriL):
  # 0.5 (tr(Sp^-1 Sq) + (mp-mq)^T Sp^-1 (mp-mq) - d + logdet Sp - logdet Sq)
  d = q.event_shape[0]
  Lq, Lp = q.scale_tril, p.scale_tril
  M = _tril_solve(Lp, Lq)
  tr = torch.sum(M * M, dim=(-2, -1))
  diff = (p.loc - q.loc) * torch.ones(q.batch_shape + q.event_shape,
                                      dtype=q.loc.dtype, device=q.loc.device)
  z = _tril_solve(Lp, diff[..., None])[..., 0]
  maha = torch.sum(z * z, dim=-1)
  return 0.5 * (tr + maha - d) + _half_logdet(Lp) - _half_logdet(Lq)


@register_kl(MultivariateNormalDiag, MultivariateNormalTriL)
def _kl_diag_tril(q: MultivariateNormalDiag, p: MultivariateNormalTriL):
  d = q.event_shape[0]
  Lq = torch.diag_embed(q.scale_diag.expand(tuple(q.batch_shape) + (d,)))
  return _kl_mvntril(MultivariateNormalTriL(q.loc, Lq), p)


@register_kl(Normal, MultivariateNormalDiag)
def _kl_normal_mvndiag(q: Normal, p: MultivariateNormalDiag):
  # an Independent-Normal posterior against an MVNDiag prior: the
  # elementwise normal KL summed over the event axis
  return _kl_mvndiag(MultivariateNormalDiag(q.loc, q.scale.expand(
      q.loc.shape)), p)


class NormalGamma(Distribution):
  """tau ~ Gamma(alpha, beta), x | tau ~ N(loc, 1/(lam tau)); samples are
  (x, tau) stacked on the last axis, and ``log_prob`` reads that layout.
  A sample draws tau's Gamma draws, then x's normal."""
  _params = ("loc", "lam", "alpha", "beta")

  def __init__(self, loc, lam, alpha, beta):
    self.loc = _float(loc)
    self.lam = _float(lam)
    self.alpha = _float(alpha)
    self.beta = _float(beta)

  @property
  def batch_shape(self):
    return torch.broadcast_shapes(self.loc.shape, self.lam.shape,
                                  self.alpha.shape, self.beta.shape)

  @property
  def event_shape(self):
    return (2,)

  def sample_from(self, noise, sample_shape=()):
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    tau = torch.exp(_log_gamma(noise, self.alpha, shape)) / self.beta
    e = noise.normal(shape, self.loc.dtype, self.loc.device)
    x = self.loc + e / torch.sqrt(self.lam * tau)
    return torch.stack([x, tau], dim=-1)

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self.sample_from(_draws(generator, eps, self.loc.device),
                            sample_shape)

  def log_prob(self, value):
    x, tau = value[..., 0], value[..., 1]
    return (Gamma(self.alpha, self.beta).log_prob(tau) +
            Normal(self.loc, 1.0 / torch.sqrt(self.lam * tau)).log_prob(x))

  def mean(self):
    shape = self.batch_shape
    return torch.stack([self.loc.expand(shape),
                        (self.alpha / self.beta).expand(shape)], dim=-1)


class LogUniform(Distribution):
  """The reciprocal distribution on [low, high]: p(x) ∝ 1/x; a sample is
  ``exp(log low + u (log high - log low))``, the noise `eps` is u."""
  _params = ("low", "high")

  def __init__(self, low, high):
    self.low = _float(low)
    self.high = _float(high)

  @property
  def batch_shape(self):
    return torch.broadcast_shapes(self.low.shape, self.high.shape)

  def sample(self, sample_shape=(), generator=None, eps=None):
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    u = _uniforms(shape, self.low, generator, eps, tiny=False)
    log_low = torch.log(self.low)
    return torch.exp(log_low + u * (torch.log(self.high) - log_low))

  def sample_from(self, noise, sample_shape=()):
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    return self.sample(sample_shape, eps=noise.uniform(
        shape, self.low.dtype, self.low.device))

  def log_prob(self, x):
    norm = torch.log(self.high) - torch.log(self.low)
    inside = (x >= self.low) & (x <= self.high)
    lp = -torch.log(x) - torch.log(norm)
    return torch.where(inside, lp, torch.full_like(lp, -math.inf))

  def mean(self):
    return ((self.high - self.low) /
            (torch.log(self.high) - torch.log(self.low))).expand(
                self.batch_shape)
