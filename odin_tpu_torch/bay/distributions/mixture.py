"""Mixture distributions of the port (PyTorch port of
``odin_tpu/bay/distributions/mixture.py``: ``MixtureSameFamily`` :20,
``GaussianMixture`` :86)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from odin_tpu_torch.bay.distributions.base import Distribution
from odin_tpu_torch.bay.distributions.discrete import Categorical

__all__ = ["MixtureSameFamily", "GaussianMixture"]


class MixtureSameFamily(Distribution):
  """Mixture over the last batch axis of `components_distribution`
  (batch_shape ``(..., K)``, any event_shape), weighted by the
  ``Categorical`` `mixture_distribution` over K."""

  def __init__(self, mixture_distribution: Categorical,
               components_distribution: Distribution):
    self.mixture_distribution = mixture_distribution
    self.components_distribution = components_distribution

  @property
  def batch_shape(self):
    return tuple(self.components_distribution.batch_shape)[:-1]

  @property
  def event_shape(self):
    return tuple(self.components_distribution.event_shape)

  @property
  def num_components(self) -> int:
    return self.components_distribution.batch_shape[-1]

  @property
  def dtype(self):
    return self.components_distribution.dtype

  def _weights(self, w):
    """`w` over K with one axis a dim of the event appended."""
    return w.reshape(tuple(w.shape) + (1,) * len(self.event_shape))

  def _select(self, comps, idx):
    e = len(self.event_shape)
    onehot = self._weights(F.one_hot(idx, self.num_components).to(
        comps.dtype))
    return torch.sum(comps * onehot, dim=comps.ndim - e - 1)

  def sample(self, sample_shape=(), generator=None, eps=None):
    """`eps`, where given, is (the components' noise, the categorical's
    uniforms)."""
    ce, me = eps if eps is not None else (None, None)
    comps = self.components_distribution.sample(sample_shape, generator, ce)
    idx = self.mixture_distribution.sample(sample_shape, generator, me)
    return self._select(comps, idx)

  def sample_from(self, noise, sample_shape=()):
    """The components' draw, then the component index: JAX's order."""
    comps = self.components_distribution.sample_from(noise, sample_shape)
    idx = self.mixture_distribution.sample_from(noise, sample_shape)
    return self._select(comps, idx)

  def log_prob(self, x):
    e = len(self.event_shape)
    lp = self.components_distribution.log_prob(x.unsqueeze(x.ndim - e))
    logw = F.log_softmax(self.mixture_distribution.logits, dim=-1)
    return torch.logsumexp(lp + logw, dim=-1)

  def mean(self):
    w = self._weights(F.softmax(self.mixture_distribution.logits, dim=-1))
    m = self.components_distribution.mean()
    return torch.sum(w * m, dim=-1 - len(self.event_shape))

  def variance(self):
    e = len(self.event_shape)
    w = self._weights(F.softmax(self.mixture_distribution.logits, dim=-1))
    m = self.components_distribution.mean()
    v = self.components_distribution.variance()
    mix_mean = torch.sum(w * m, dim=-1 - e, keepdim=True)
    return torch.sum(w * (v + (m - mix_mean) ** 2), dim=-1 - e)


def GaussianMixture(logits, locs, scales, covariance: str = "diag"):
  """A mixture of Gaussians over K components: 'none'/'scalar' (scalar
  Normals), 'diag' (``MultivariateNormalDiag``, `scales` the diagonals)
  or 'tril'/'full' (``MultivariateNormalTriL``, `scales` the
  lower-triangular factors)."""
  from odin_tpu_torch.bay.distributions.continuous import (
      MultivariateNormalDiag, MultivariateNormalTriL, Normal)
  if covariance in ("none", "scalar"):
    comps = Normal(locs, scales)
  elif covariance == "diag":
    comps = MultivariateNormalDiag(locs, scales)
  elif covariance in ("tril", "full"):
    comps = MultivariateNormalTriL(locs, scales)
  else:
    raise ValueError(f"unknown covariance: {covariance}")
  return MixtureSameFamily(Categorical(logits=logits), comps)
