"""Gaussian families of the port (``Normal`` and ``MultivariateNormalDiag``
of ``odin_tpu/bay/distributions/continuous.py:72,402``), the ``Logistic``
and ``Uniform`` (:148,188) the quantized likelihoods stand on, and the
``Dirichlet`` (:346-399).

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

__all__ = ["Normal", "MultivariateNormalDiag", "Logistic", "Uniform",
           "Dirichlet"]

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
