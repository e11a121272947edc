"""Hyperspherical distributions of the port (PyTorch port of
``odin_tpu/bay/distributions/spherical.py``): ``SphericalUniform`` (:30),
``VonMisesFisher`` (:94) and ``PowerSpherical`` (:190), their KLs to the
uniform (:186, :259) and the log-Bessel function ``_log_iv_bessel``
(:64-92), with its series and asymptotic branches as the JAX package has
them.

Sampling takes its draws from a ``training.core.Noise`` (``sample_from``):

  * vMF: the cosine ``w`` to the mean direction by Wood's (1994) proposal
    and acceptance test, `VMF_PROPOSALS` proposals a row drawn at once
    (``sampling``'s fixed-rounds scheme, counted as kind ``'vmf'``), then
    a normal for the tangent direction.  JAX runs the same test in a
    ``while_loop`` until every row accepts; the first accepted proposal
    has the same law either way.  ``w`` carries no gradient, as in JAX.
  * PowerSpherical: two log-Gamma variates (``Noise.log_gamma``) whose
    ratio is the Beta variate, as ``jax.random.beta`` forms it, with
    implicit reparameterisation gradients through the Gamma
    concentration (``torch._standard_gamma_grad``, as JAX's
    ``random_gamma_grad``), then a normal for the direction.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from odin_tpu_torch.bay.distributions.base import Distribution, register_kl
from odin_tpu_torch.bay.distributions.sampling import (
    _stats,
    check_rejections,
    sample_beta,
)

__all__ = ["SphericalUniform", "VonMisesFisher", "PowerSpherical",
           "VMF_PROPOSALS"]

VMF_PROPOSALS = 32


def _log_surface_sphere(d: int) -> float:
  """log of the area of S^{d-1} in R^d."""
  return math.log(2.0) + (d / 2.0) * math.log(math.pi) - math.lgamma(d / 2.0)


def _default_generator(device: torch.device) -> torch.Generator:
  if device.type == "cuda":
    return torch.cuda.default_generators[device.index or 0]
  return torch.default_generator


def _noise(generator, eps, device):
  from odin_tpu_torch.training.core import Noise
  if eps is not None:
    return Noise(eps=eps)
  return Noise(generator if generator is not None
               else _default_generator(device))


class SphericalUniform(Distribution):
  """Uniform on the unit sphere S^{d-1} in R^d."""

  def __init__(self, dimension: int, batch_shape=()):
    self.dimension = int(dimension)
    self._batch_shape = tuple(batch_shape)

  @property
  def batch_shape(self):
    return self._batch_shape

  @property
  def event_shape(self):
    return (self.dimension,)

  def sample_from(self, noise, sample_shape=(), device=None):
    shape = tuple(sample_shape) + self.batch_shape + (self.dimension,)
    x = noise.normal(shape, torch.float32, device or torch.device("cpu"))
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

  def sample(self, sample_shape=(), generator=None, eps=None):
    device = generator.device if generator is not None else torch.device(
        "cpu")
    return self.sample_from(_noise(generator, eps, device), sample_shape,
                            device)

  def log_prob(self, x):
    return torch.full(tuple(x.shape[:-1]),
                      -_log_surface_sphere(self.dimension), dtype=x.dtype,
                      device=x.device)

  def mean(self):
    return torch.zeros(self.batch_shape + (self.dimension,))

  def entropy(self):
    return torch.full(self.batch_shape, _log_surface_sphere(self.dimension))


def _log_iv_bessel(nu: float, kappa: torch.Tensor) -> torch.Tensor:
  """log I_nu(kappa): the 40-term power series below kappa = 20, the
  leading term of the uniform asymptotic expansion (Abramowitz & Stegun
  9.7.7) above, as the JAX package computes it."""

  def series(k):
    # clamped to the switch point, so that the other branch's gradient
    # never meets an overflowing series
    k = torch.clamp(k, max=20.0)
    log_base = nu * (torch.log(k) - math.log(2.0)) - math.lgamma(nu + 1.0)
    s = torch.ones_like(k)
    acc = torch.ones_like(k)
    for j in range(1, 40):
      acc = acc * (k * k / 4.0) / (j * (nu + j))
      s = s + acc
    return log_base + torch.log(s)

  def asymptotic(k):
    if nu > 0:
      eta = torch.sqrt(nu * nu + k * k)
      return (eta - nu * torch.log((nu + eta) / k) -
              0.5 * torch.log(2.0 * math.pi * eta))
    return k - 0.5 * torch.log(2.0 * math.pi * k)

  k = torch.clamp(kappa, min=1e-6)
  return torch.where(kappa < 20.0, series(k), asymptotic(k))


class _SphericalBase(Distribution):
  _params = ("mean_direction", "concentration")

  def __init__(self, mean_direction, concentration):
    self.mean_direction = torch.as_tensor(mean_direction)
    self.concentration = torch.as_tensor(concentration)

  @property
  def batch_shape(self):
    return self.mean_direction.shape[:-1]

  @property
  def event_shape(self):
    return self.mean_direction.shape[-1:]

  @property
  def _d(self) -> int:
    return int(self.mean_direction.shape[-1])

  def sample(self, sample_shape=(), generator=None, eps=None):
    """A sample from `generator` (the device's default generator if None),
    or from `eps`, the list of draws ``sample_from`` makes.  Raises where
    a row found no accepted proposal (``check_rejections``)."""
    out = self.sample_from(_noise(generator, eps,
                                  self.mean_direction.device), sample_shape)
    check_rejections()
    return out


class VonMisesFisher(_SphericalBase):
  """vMF(mean_direction mu, concentration kappa) on S^{d-1}."""

  def _log_normalizer(self):
    d = self._d
    nu = d / 2.0 - 1.0
    k = torch.clamp(self.concentration, min=1e-8)
    return (nu * torch.log(k) - (d / 2.0) * math.log(2.0 * math.pi) -
            _log_iv_bessel(nu, k))

  def log_prob(self, x):
    dot = torch.sum(self.mean_direction * x, dim=-1)
    return self.concentration * dot + self._log_normalizer()

  @torch.no_grad()
  def _sample_w(self, generator, shape) -> torch.Tensor:
    """The cosine of the angle to mu, `shape`, by Wood's scheme: the first
    accepted of `VMF_PROPOSALS` proposals, NaN (and counted) where none
    is."""
    d = self._d
    mu = self.mean_direction
    k = torch.clamp(self.concentration, min=1e-8).expand(shape)
    dim = d - 1.0
    root = torch.sqrt(4.0 * k * k + dim * dim)
    b = dim / (root + 2.0 * k)
    a = (dim + 2.0 * k + root) / 4.0
    dterm = 4.0 * a * b / (1.0 + b) - dim * math.log(dim)
    prop = (VMF_PROPOSALS,) + tuple(shape)
    eps = sample_beta(generator, dim / 2.0, dim / 2.0, prop, mu.dtype,
                      mu.device)
    u = 1e-10 + torch.rand(prop, generator=generator, dtype=mu.dtype,
                           device=mu.device)
    w_new = (1.0 - (1.0 + b) * eps) / (1.0 - (1.0 - b) * eps)
    t = 2.0 * a * b / (1.0 - (1.0 - b) * eps)
    accept = (dim * torch.log(t) - t + dterm) >= torch.log(u)
    first = torch.argmax(accept.to(torch.int8), dim=0, keepdim=True)
    w = torch.take_along_dim(w_new, first, dim=0)[0]
    hit = accept.any(dim=0)
    _stats("vmf", mu.device).add(accept.numel(), accept.sum(), hit.numel(),
                                 (~hit).sum())
    return torch.where(hit, w, torch.full_like(w, float("nan")))

  def sample_from(self, noise, sample_shape=()):
    d = self._d
    mu = self.mean_direction
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    w = noise.draw(shape, mu.dtype, mu.device,
                   lambda g: self._sample_w(g, shape))
    v = noise.normal(shape + (d,), mu.dtype, mu.device)
    mu = mu.expand(shape + (d,))
    v = v - torch.sum(v * mu, -1, keepdim=True) * mu
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                        min=1e-12)
    w = w[..., None]
    return w * mu + torch.sqrt(torch.clamp(1.0 - w ** 2, min=0.0)) * v

  def _bessel_ratio(self):
    d = self._d
    k = torch.clamp(self.concentration, min=1e-8)
    nu = d / 2.0 - 1.0
    return k, torch.exp(_log_iv_bessel(nu + 1.0, k) - _log_iv_bessel(nu, k))

  def mean(self):
    """A_d(kappa) mu, A_d = I_{d/2} / I_{d/2-1}."""
    _, a = self._bessel_ratio()
    return a[..., None] * self.mean_direction

  def entropy(self):
    k, a = self._bessel_ratio()
    return -self._log_normalizer() - k * a


@register_kl(VonMisesFisher, SphericalUniform)
def _kl_vmf_uniform(q: VonMisesFisher, p: SphericalUniform):
  return -q.entropy() + _log_surface_sphere(p.dimension)


class _ImplicitLogGamma(torch.autograd.Function):
  """The identity on a log-Gamma(alpha) sample, whose gradient to alpha is
  the implicit reparameterisation ``(dx/dalpha) / x`` (JAX's
  ``_gamma_grad`` in log space; x = 0 taken as the smallest float)."""

  @staticmethod
  def forward(ctx, log_x, alpha):
    ctx.save_for_backward(log_x, alpha)
    return log_x.clone()

  @staticmethod
  def backward(ctx, grad):
    log_x, alpha = ctx.saved_tensors
    x = torch.exp(log_x)
    x = torch.where(x == 0, torch.full_like(x, torch.finfo(x.dtype).tiny), x)
    return None, grad * torch._standard_gamma_grad(alpha, x) / x


class PowerSpherical(_SphericalBase):
  """Power Spherical (De Cao & Aziz 2020): density proportional to
  ``(1 + mu^T x)^kappa``."""

  def _ab(self):
    d = self._d
    return (d - 1.0) / 2.0 + self.concentration, (d - 1.0) / 2.0

  def _log_normalizer(self):
    alpha, beta = self._ab()
    return -((alpha + beta) * math.log(2.0) + torch.lgamma(alpha) -
             torch.lgamma(alpha + beta) + beta * math.log(math.pi))

  def log_prob(self, x):
    dot = torch.sum(self.mean_direction * x, dim=-1)
    return self._log_normalizer() + self.concentration * torch.log1p(dot)

  def sample_from(self, noise, sample_shape=()):
    d = self._d
    mu = self.mean_direction
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    alpha = ((d - 1.0) / 2.0 + self.concentration).expand(shape)
    beta = torch.full(shape, (d - 1.0) / 2.0, dtype=mu.dtype,
                      device=mu.device)
    log_a = _ImplicitLogGamma.apply(
        noise.log_gamma(alpha.detach(), shape, mu.dtype, mu.device), alpha)
    log_b = noise.log_gamma(beta, shape, mu.dtype, mu.device)
    # the Beta variate from the log-Gammas, as jax.random.beta forms it
    log_max = torch.maximum(log_a, log_b)
    ga, gb = torch.exp(log_a - log_max), torch.exp(log_b - log_max)
    t = 2.0 * (ga / (ga + gb)) - 1.0
    v = noise.normal(shape + (d - 1,), mu.dtype, mu.device)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                        min=1e-12)
    t = t[..., None]
    y = torch.cat([t, torch.sqrt(torch.clamp(1.0 - t ** 2, min=0.0)) * v],
                  dim=-1)
    # the Householder reflection taking e1 onto mu
    mu = mu.expand(shape + (d,))
    e1 = torch.zeros_like(mu)
    e1[..., 0] = 1.0
    u = e1 - mu
    u = u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True),
                        min=1e-12)
    return y - 2.0 * torch.sum(y * u, -1, keepdim=True) * u

  def mean(self):
    alpha, beta = self._ab()
    return ((alpha - beta) / (alpha + beta))[..., None] * self.mean_direction

  def entropy(self):
    alpha, beta = self._ab()
    return -(self._log_normalizer() + self.concentration * (
        math.log(2.0) + torch.digamma(alpha) - torch.digamma(alpha + beta)))


@register_kl(PowerSpherical, SphericalUniform)
def _kl_powerspherical_uniform(q: PowerSpherical, p: SphericalUniform):
  return -q.entropy() + _log_surface_sphere(p.dimension)
