"""Discrete and count families of the port (PyTorch port of
``odin_tpu/bay/distributions/discrete.py``): ``Bernoulli`` :51,
``ContinuousBernoulli`` :103, ``Categorical`` :126, ``OneHotCategorical``
:167, ``RelaxedBernoulli`` :202, ``RelaxedOneHotCategorical`` :232,
``Poisson`` :267, ``Binomial`` :305, ``Multinomial`` :340,
``DirichletMultinomial`` :380, ``NegativeBinomial`` :419,
``NegativeBinomialDisp`` :457 and ``ZeroInflated`` :497, with JAX's
registered KLs.

Draws come from a ``training.core.Noise`` in JAX's order: a Bernoulli (a
zero-inflation gate too) is a uniform below its probability, as
``jax.random.bernoulli`` draws; the relaxed families take a uniform in
[1e-6, 1 - 1e-6) or Gumbel variates; the counts (``torch.poisson``,
``torch.binomial``, the Gamma-Poisson of the negative binomials) draw
from the Noise's generator, and cannot be matched draw for draw with
JAX's samplers.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from odin_tpu_torch.bay.distributions.base import Distribution, register_kl
from odin_tpu_torch.bay.distributions.continuous import (Dirichlet, _draws,
                                                        _float)

__all__ = ["Bernoulli", "ContinuousBernoulli", "Categorical",
           "OneHotCategorical", "RelaxedBernoulli",
           "RelaxedOneHotCategorical", "Poisson", "Binomial", "Multinomial",
           "DirichletMultinomial", "NegativeBinomial", "NegativeBinomialDisp",
           "ZeroInflated"]




def _logits_from(logits, probs) -> torch.Tensor:
  """Bernoulli logits from exactly one of `logits` and `probs`."""
  if (logits is None) == (probs is None):
    raise ValueError("exactly one of logits/probs must be given")
  if logits is not None:
    return torch.as_tensor(logits)
  probs = torch.as_tensor(probs)
  return torch.log(probs) - torch.log1p(-probs)


def _cat_logits_from(logits, probs) -> torch.Tensor:
  """Normalised categorical logits from exactly one of `logits` (minus
  their logsumexp) and `probs` (their log)."""
  if (logits is None) == (probs is None):
    raise ValueError("exactly one of logits/probs must be given")
  if logits is not None:
    logits = torch.as_tensor(logits)
    return logits - torch.logsumexp(logits, dim=-1, keepdim=True)
  return torch.log(torch.as_tensor(probs))


class Bernoulli(Distribution):
  """Bernoulli over its logits, given as `logits` or as `probs`."""
  _params = ("logits",)

  def __init__(self, logits=None, probs=None):
    self.logits = _logits_from(logits, probs)

  @property
  def batch_shape(self):
    return self.logits.shape

  @property
  def probs(self):
    return torch.sigmoid(self.logits)

  def sample_from(self, noise, sample_shape=()):
    """1 where a uniform of the noise is below the probability, as
    ``jax.random.bernoulli`` draws."""
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    u = noise.uniform(shape, self.logits.dtype, self.logits.device)
    return (u < self.probs).to(torch.float32)

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self.sample_from(_draws(generator, eps, self.logits.device),
                            sample_shape)

  def log_prob(self, x):
    # -BCE(x, sigmoid(logits)), valid for soft targets x in [0, 1]
    lp1 = -F.softplus(-self.logits)  # log sigmoid
    lp0 = -F.softplus(self.logits)  # log (1 - sigmoid)
    return x * lp1 + (1.0 - x) * lp0

  def mean(self):
    return self.probs

  def mode(self):
    return (self.logits > 0).to(torch.float32)

  def variance(self):
    p = self.probs
    return p * (1.0 - p)

  def entropy(self):
    p = self.probs
    return -(p * -F.softplus(-self.logits) + (1.0 - p) *
             -F.softplus(self.logits))


@register_kl(Bernoulli, Bernoulli)
def _kl_bernoulli(q: Bernoulli, p: Bernoulli):
  pq = q.probs
  lq1, lq0 = -F.softplus(-q.logits), -F.softplus(q.logits)
  lp1, lp0 = -F.softplus(-p.logits), -F.softplus(p.logits)
  return pq * (lq1 - lp1) + (1.0 - pq) * (lq0 - lp0)


class Categorical(Distribution):
  """Integer-valued categorical over the last axis of `logits`
  (normalised by their logsumexp) or of `probs` (their log)."""
  _params = ("logits",)

  def __init__(self, logits=None, probs=None):
    self.logits = _cat_logits_from(logits, probs)

  @property
  def num_categories(self) -> int:
    return self.logits.shape[-1]

  @property
  def batch_shape(self):
    return self.logits.shape[:-1]

  @property
  def probs(self):
    return F.softmax(self.logits, dim=-1)

  def sample(self, sample_shape=(), generator=None, eps=None):
    """The Gumbel-max index over `eps` (uniforms shaped ``sample_shape +
    logits.shape``), drawn from `generator` if not given."""
    shape = tuple(sample_shape) + tuple(self.logits.shape)
    u = eps if eps is not None else torch.rand(
        shape, generator=generator, dtype=self.logits.dtype,
        device=self.logits.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, 1e-20, 1.0)))
    return torch.argmax(self.logits + gumbel, dim=-1)

  def sample_from(self, noise, sample_shape=()):
    """The Gumbel-max index over the noise's Gumbel variates, as
    ``jax.random.categorical`` draws."""
    shape = tuple(sample_shape) + tuple(self.logits.shape)
    return torch.argmax(self.logits + noise.gumbel(
        shape, self.logits.dtype, self.logits.device), dim=-1)

  def log_prob(self, x):
    x = torch.as_tensor(x, device=self.logits.device).to(torch.int64)
    shape = torch.broadcast_shapes(x.shape, self.logits.shape[:-1])
    logits = self.logits.expand(tuple(shape) + self.logits.shape[-1:])
    return torch.gather(logits, -1, x.expand(shape)[..., None])[..., 0]

  def mode(self):
    return torch.argmax(self.logits, dim=-1)

  def entropy(self):
    return -torch.sum(self.probs * self.logits, dim=-1)


@register_kl(Categorical, Categorical)
def _kl_categorical(q: Categorical, p: Categorical):
  return torch.sum(q.probs * (q.logits - p.logits), dim=-1)


class OneHotCategorical(Distribution):
  """One-hot categorical over the last axis of `logits` (normalised by
  their logsumexp, as the JAX package keeps them) or of `probs` (their
  log); event_shape (K,)."""
  _params = ("logits",)

  def __init__(self, logits=None, probs=None):
    self.logits = _cat_logits_from(logits, probs)

  @property
  def num_categories(self) -> int:
    return self.logits.shape[-1]

  @property
  def batch_shape(self):
    return self.logits.shape[:-1]

  @property
  def event_shape(self):
    return self.logits.shape[-1:]

  @property
  def probs(self):
    return F.softmax(self.logits, dim=-1)

  def sample(self, sample_shape=(), generator=None, eps=None):
    """One-hot of the Gumbel-max index over `eps` (uniforms shaped
    ``sample_shape + logits.shape``), drawn from `generator` if not
    given."""
    shape = tuple(sample_shape) + tuple(self.logits.shape)
    u = eps if eps is not None else torch.rand(
        shape, generator=generator, dtype=self.logits.dtype,
        device=self.logits.device)
    return self._gumbel_max(-torch.log(-torch.log(torch.clamp(u, 1e-20,
                                                              1.0))))

  def sample_from(self, noise, sample_shape=()):
    """One-hot of the Gumbel-max index over the noise's Gumbel variates
    (``sample_shape + logits.shape``), as ``jax.random.categorical``
    draws."""
    shape = tuple(sample_shape) + tuple(self.logits.shape)
    return self._gumbel_max(noise.gumbel(shape, self.logits.dtype,
                                         self.logits.device))

  def _gumbel_max(self, gumbel):
    idx = torch.argmax(self.logits + gumbel, dim=-1)
    return F.one_hot(idx, self.logits.shape[-1]).to(torch.float32)

  def log_prob(self, x):
    return torch.sum(x * self.logits, dim=-1)

  def mean(self):
    return self.probs

  def mode(self):
    return F.one_hot(torch.argmax(self.logits, dim=-1),
                     self.logits.shape[-1]).to(torch.float32)

  def variance(self):
    p = self.probs
    return p * (1.0 - p)

  def entropy(self):
    return -torch.sum(self.probs * self.logits, dim=-1)


@register_kl(OneHotCategorical, OneHotCategorical)
def _kl_onehot(q: OneHotCategorical, p: OneHotCategorical):
  return torch.sum(q.probs * (q.logits - p.logits), dim=-1)


class ContinuousBernoulli(Bernoulli):
  """The Bernoulli density normalised over [0, 1] (Loaiza-Ganem and
  Cunningham 2019); its samples, mode, variance and entropy are the
  Bernoulli's, as in the JAX package."""

  def _lam(self):
    lam = torch.clamp(self.probs, 1e-6, 1.0 - 1e-6)
    near = torch.abs(lam - 0.5) < 1e-4
    return lam, near, torch.where(near, torch.full_like(lam, 0.4999), lam)

  def _log_norm_const(self):
    # C(lam) = 2 atanh(1 - 2 lam) / (1 - 2 lam) for lam != 0.5, else 2
    lam, near, safe = self._lam()
    log_c = (torch.log(torch.abs(2.0 * torch.atanh(1.0 - 2.0 * safe))) -
             torch.log(torch.abs(1.0 - 2.0 * safe)))
    taylor = math.log(2.0) + 4.0 / 3.0 * (lam - 0.5) ** 2
    return torch.where(near, taylor, log_c)

  def log_prob(self, x):
    return super().log_prob(x) + self._log_norm_const()

  def mean(self):
    lam, near, safe = self._lam()
    m = safe / (2.0 * safe - 1.0) + 1.0 / (2.0 * torch.atanh(1.0 - 2.0 *
                                                             safe))
    return torch.where(near, torch.full_like(lam, 0.5), m)


class RelaxedBernoulli(Distribution):
  """The binary Concrete: ``sigmoid((logits + logit(u)) / temperature)``
  of a uniform u in [1e-6, 1 - 1e-6) (the noise `eps`)."""
  _params = ("temperature", "logits")

  def __init__(self, temperature, logits=None, probs=None):
    self.temperature = _float(temperature)
    self.logits = _logits_from(logits, probs)

  @property
  def batch_shape(self):
    return self.logits.shape

  def _from_uniform(self, u):
    u = torch.clamp(u, 1e-6, 1.0 - 1e-6)
    return torch.sigmoid((self.logits + torch.log(u) - torch.log1p(-u)) /
                         self.temperature)

  def sample_from(self, noise, sample_shape=()):
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    return self._from_uniform(noise.uniform(shape, self.logits.dtype,
                                            self.logits.device))

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self.sample_from(_draws(generator, eps, self.logits.device),
                            sample_shape)

  def log_prob(self, x):
    t = self.temperature
    x = torch.clamp(x, 1e-6, 1.0 - 1e-6)
    z = self.logits - t * (torch.log(x) - torch.log1p(-x))
    return torch.log(t) + z - 2.0 * F.softplus(z) - torch.log(x * (1.0 - x))

  def mean(self):
    return torch.sigmoid(self.logits)  # the underlying Bernoulli's


class RelaxedOneHotCategorical(Distribution):
  """The Gumbel-softmax: ``softmax((logits + g) / temperature)`` of
  Gumbel variates g (the noise `eps`)."""
  _params = ("temperature", "logits")

  def __init__(self, temperature, logits=None, probs=None):
    self.temperature = _float(temperature)
    self.logits = _cat_logits_from(logits, probs)

  @property
  def batch_shape(self):
    return self.logits.shape[:-1]

  @property
  def event_shape(self):
    return self.logits.shape[-1:]

  def sample_from(self, noise, sample_shape=()):
    shape = tuple(sample_shape) + tuple(self.logits.shape)
    g = noise.gumbel(shape, self.logits.dtype, self.logits.device)
    return F.softmax((self.logits + g) / self.temperature, dim=-1)

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self.sample_from(_draws(generator, eps, self.logits.device),
                            sample_shape)

  def log_prob(self, x):
    k = self.logits.shape[-1]
    t = self.temperature
    logx = torch.log(torch.clamp(x, 1e-10, 1.0))
    score = self.logits - t * logx
    return (math.lgamma(float(k)) + (k - 1) * torch.log(t) +
            torch.sum(score, dim=-1) - torch.sum(logx, dim=-1) -
            k * torch.logsumexp(score, dim=-1))

  def mean(self):
    return F.softmax(self.logits, dim=-1)


def _counts(noise, make, shape, like: torch.Tensor):
  """A count draw of `shape` from the noise: ``make(generator)``, or the
  next injected tensor."""
  return noise.draw(shape, torch.float32, like.device, make)


class Poisson(Distribution):
  """Poisson over its log-rate, given as `rate` or `log_rate`."""
  _params = ("log_rate",)

  def __init__(self, rate=None, log_rate=None):
    if (rate is None) == (log_rate is None):
      raise ValueError("exactly one of rate/log_rate")
    self.log_rate = (torch.log(_float(rate)) if rate is not None
                     else _float(log_rate))

  @property
  def batch_shape(self):
    return self.log_rate.shape

  @property
  def rate(self):
    return torch.exp(self.log_rate)

  def sample_from(self, noise, sample_shape=()):
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    rate = self.rate.detach().expand(shape)
    return _counts(noise, lambda g: torch.poisson(rate, generator=g), shape,
                   rate)

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self.sample_from(_draws(generator, eps, self.log_rate.device),
                            sample_shape)

  def log_prob(self, x):
    return x * self.log_rate - self.rate - torch.lgamma(x + 1.0)

  def mean(self):
    return self.rate

  def mode(self):
    return torch.floor(self.rate)

  def variance(self):
    return self.rate


@register_kl(Poisson, Poisson)
def _kl_poisson(q: Poisson, p: Poisson):
  return q.rate * (q.log_rate - p.log_rate) - q.rate + p.rate


class Binomial(Distribution):
  """Binomial(total_count, p) over the logits of p."""
  _params = ("total_count", "logits")

  def __init__(self, total_count, logits=None, probs=None):
    self.total_count = torch.as_tensor(total_count, dtype=torch.float32)
    self.logits = _logits_from(logits, probs)

  @property
  def batch_shape(self):
    return torch.broadcast_shapes(self.total_count.shape, self.logits.shape)

  @property
  def probs(self):
    return torch.sigmoid(self.logits)

  def sample_from(self, noise, sample_shape=()):
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    n = self.total_count.to(self.logits.device).expand(shape)
    p = self.probs.detach().expand(shape)
    return _counts(noise, lambda g: torch.binomial(n, p, generator=g), shape,
                   p)

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self.sample_from(_draws(generator, eps, self.logits.device),
                            sample_shape)

  def log_prob(self, x):
    n = self.total_count.to(self.logits.device)
    return (torch.lgamma(n + 1.0) - torch.lgamma(x + 1.0) -
            torch.lgamma(n - x + 1.0) + x * -F.softplus(-self.logits) +
            (n - x) * -F.softplus(self.logits))

  def mean(self):
    return self.total_count.to(self.logits.device) * self.probs

  def variance(self):
    p = self.probs
    return self.total_count.to(self.logits.device) * p * (1.0 - p)


def _multinomial_counts(n: torch.Tensor, probs: torch.Tensor,
                        generator) -> torch.Tensor:
  """Multinomial counts of `n` trials over the last axis of `probs`: a
  Binomial for each category given the trials the ones before it left."""
  left = n.clone()
  rest = torch.ones_like(n)
  out = []
  for k in range(probs.shape[-1] - 1):
    p = torch.clamp(probs[..., k] / torch.clamp(rest, min=1e-30), 0.0, 1.0)
    x = torch.binomial(left, p, generator=generator)
    out.append(x)
    left = left - x
    rest = rest - probs[..., k]
  out.append(left)
  return torch.stack(out, dim=-1)


class Multinomial(Distribution):
  """Multinomial(total_count, softmax(logits)) over the last axis."""
  _params = ("total_count", "logits")

  def __init__(self, total_count, logits=None, probs=None):
    self.total_count = torch.as_tensor(total_count, dtype=torch.float32)
    self.logits = _cat_logits_from(logits, probs)

  @property
  def batch_shape(self):
    return torch.broadcast_shapes(self.total_count.shape,
                                  self.logits.shape[:-1])

  @property
  def event_shape(self):
    return self.logits.shape[-1:]

  @property
  def probs(self):
    return F.softmax(self.logits, dim=-1)

  def _n(self):
    n = self.total_count.to(self.logits.device)
    return n[..., None] if n.ndim else n

  def sample_from(self, noise, sample_shape=()):
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    n = torch.floor(self.total_count.to(self.logits.device)).expand(shape)
    p = self.probs.detach().expand(shape + tuple(self.event_shape))
    return _counts(noise, lambda g: _multinomial_counts(n, p, g),
                   shape + tuple(self.event_shape), p)

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self.sample_from(_draws(generator, eps, self.logits.device),
                            sample_shape)

  def log_prob(self, x):
    n = self.total_count.to(self.logits.device)
    return (torch.lgamma(n + 1.0) - torch.sum(torch.lgamma(x + 1.0), dim=-1)
            + torch.sum(x * self.logits, dim=-1))

  def mean(self):
    return self._n() * self.probs

  def variance(self):
    p = self.probs
    return self._n() * p * (1.0 - p)


class DirichletMultinomial(Distribution):
  """Multinomial counts over probabilities drawn from a Dirichlet; a
  sample draws the Dirichlet's Gammas (JAX's draws), then the counts."""
  _params = ("total_count", "concentration")

  def __init__(self, total_count, concentration):
    self.total_count = torch.as_tensor(total_count, dtype=torch.float32)
    self.concentration = _float(concentration)

  @property
  def batch_shape(self):
    return torch.broadcast_shapes(self.total_count.shape,
                                  self.concentration.shape[:-1])

  @property
  def event_shape(self):
    return self.concentration.shape[-1:]

  def sample_from(self, noise, sample_shape=()):
    p = Dirichlet(self.concentration).sample_from(noise, sample_shape)
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    p = p.detach().expand(shape + tuple(self.event_shape))
    n = torch.floor(self.total_count.to(p.device)).expand(shape)
    return _counts(noise, lambda g: _multinomial_counts(n, p, g),
                   shape + tuple(self.event_shape), p)

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self.sample_from(_draws(generator, eps,
                                   self.concentration.device), sample_shape)

  def log_prob(self, x):
    a = self.concentration
    a0 = torch.sum(a, dim=-1)
    n = self.total_count.to(a.device)
    return (torch.lgamma(n + 1.0) - torch.sum(torch.lgamma(x + 1.0), dim=-1)
            + torch.lgamma(a0) - torch.lgamma(n + a0) +
            torch.sum(torch.lgamma(x + a) - torch.lgamma(a), dim=-1))

  def mean(self):
    a = self.concentration
    n = self.total_count.to(a.device)
    n = n[..., None] if n.ndim else n
    return n * a / torch.sum(a, dim=-1, keepdim=True)


class NegativeBinomial(Distribution):
  """NB(total_count r, logits of the success probability p): mean
  ``r e^logits``.  A sample is Poisson(Gamma(r, 1) e^logits)."""
  _params = ("total_count", "logits")

  def __init__(self, total_count, logits=None, probs=None):
    self.total_count = _float(total_count)
    self.logits = _logits_from(logits, probs)

  @property
  def batch_shape(self):
    return torch.broadcast_shapes(self.total_count.shape, self.logits.shape)

  def sample_from(self, noise, sample_shape=()):
    shape = tuple(sample_shape) + tuple(self.batch_shape)
    r = self.total_count.detach().expand(shape)
    log_g = noise.log_gamma(r, shape, r.dtype, r.device)
    rate = torch.exp(log_g + self.logits.detach()).expand(shape)
    return _counts(noise, lambda g: torch.poisson(rate, generator=g), shape,
                   rate)

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self.sample_from(_draws(generator, eps, self.logits.device),
                            sample_shape)

  def log_prob(self, x):
    r = self.total_count
    return (torch.lgamma(x + r) - torch.lgamma(r) - torch.lgamma(x + 1.0) +
            r * -F.softplus(self.logits) + x * -F.softplus(-self.logits))

  def mean(self):
    return self.total_count * torch.exp(self.logits)

  def variance(self):
    return self.mean() / torch.sigmoid(-self.logits)


class NegativeBinomialDisp(Distribution):
  """The mean/dispersion NB of scVI: NB(loc, disp) with variance ``loc +
  loc² / disp``; ``log_prob`` floors its logs at JAX's 1e-8."""
  _params = ("loc", "disp")

  def __init__(self, loc, disp):
    self.loc = _float(loc)
    self.disp = _float(disp)

  @property
  def batch_shape(self):
    return torch.broadcast_shapes(self.loc.shape, self.disp.shape)

  def _as_nb(self) -> NegativeBinomial:
    # r = disp; p = loc / (loc + disp), so logits = log(loc) - log(disp)
    logits = (torch.log(torch.clamp(self.loc, min=1e-8)) -
              torch.log(torch.clamp(self.disp, min=1e-8)))
    return NegativeBinomial(self.disp, logits=logits)

  def sample_from(self, noise, sample_shape=()):
    return self._as_nb().sample_from(noise, sample_shape)

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self._as_nb().sample(sample_shape, generator, eps)

  def log_prob(self, x):
    mu, th = self.loc, self.disp
    eps = 1e-8
    log_th_mu = torch.log(th + mu + eps)
    return (th * (torch.log(th + eps) - log_th_mu) +
            x * (torch.log(mu + eps) - log_th_mu) +
            torch.lgamma(x + th) - torch.lgamma(th) - torch.lgamma(x + 1.0))

  def mean(self):
    return self.loc.expand(self.batch_shape)

  def variance(self):
    return self.loc + self.loc ** 2 / self.disp


class ZeroInflated(Distribution):
  """A point mass at zero mixed with a count distribution, the mass's
  probability given by `logits` or `probs`.  A sample draws the counts,
  then a uniform gate per element (zero where it is below the mass's
  probability)."""

  def __init__(self, count_distribution: Distribution, logits=None,
               probs=None):
    self.count_distribution = count_distribution
    self.inflated_logits = _logits_from(logits, probs)

  @property
  def batch_shape(self):
    return torch.broadcast_shapes(tuple(self.count_distribution.batch_shape),
                                  self.inflated_logits.shape)

  @property
  def event_shape(self):
    return self.count_distribution.event_shape

  @property
  def dtype(self):
    return self.count_distribution.dtype

  def sample_from(self, noise, sample_shape=()):
    x = self.count_distribution.sample_from(noise, sample_shape)
    u = noise.uniform(tuple(x.shape), x.dtype, x.device)
    return torch.where(u < torch.sigmoid(self.inflated_logits),
                       torch.zeros_like(x), x)

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self.sample_from(_draws(generator, eps,
                                   self.inflated_logits.device), sample_shape)

  def log_prob(self, x):
    log_pi = -F.softplus(-self.inflated_logits)  # log P(inflated)
    log_1mpi = -F.softplus(self.inflated_logits)  # log P(count branch)
    zero_case = torch.logaddexp(
        log_pi, log_1mpi + self.count_distribution.log_prob(
            torch.zeros_like(x)))
    nonzero_case = log_1mpi + self.count_distribution.log_prob(x)
    return torch.where(x == 0, zero_case, nonzero_case)

  def mean(self):
    return ((1.0 - torch.sigmoid(self.inflated_logits)) *
            self.count_distribution.mean())

  def variance(self):
    pi = torch.sigmoid(self.inflated_logits)
    m = self.count_distribution.mean()
    v = self.count_distribution.variance()
    return (1 - pi) * (v + m * m) - ((1 - pi) * m) ** 2
