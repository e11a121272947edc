"""``Bernoulli``, ``Categorical`` and ``OneHotCategorical`` of the port
(``odin_tpu/bay/distributions/discrete.py:51,126,167``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from odin_tpu_torch.bay.distributions.base import Distribution, register_kl

__all__ = ["Bernoulli", "Categorical", "OneHotCategorical"]


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
