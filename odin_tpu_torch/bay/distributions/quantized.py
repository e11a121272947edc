"""Quantized likelihoods of the port (PyTorch port of
``odin_tpu/bay/distributions/quantized.py``: ``QuantizedLogistic`` :20-79,
``MixtureQuantizedLogistic`` :81, ``Quantized`` :91, ``qNormal`` :144,
``qUniform`` :152): a continuous base integrated over integer-width bins,
the edge bins taking the whole tails.

``log_prob`` takes the JAX package's branches: ``log(max(plus - minus,
1e-12))`` in the middle bins, the tails at the edges, picked with a
``where`` (the unused branches get a zero gradient and are finite, so no
NaN reaches the gradient), and ``torch.maximum``, which splits a tie's
gradient as ``jnp.maximum`` does.
"""
from __future__ import annotations

import math

import torch

from odin_tpu_torch.bay.distributions.base import Distribution
from odin_tpu_torch.bay.distributions.continuous import (Logistic, Normal,
                                                         Uniform, _float)
from odin_tpu_torch.bay.distributions.discrete import Categorical
from odin_tpu_torch.bay.distributions.mixture import MixtureSameFamily

__all__ = ["QuantizedLogistic", "MixtureQuantizedLogistic", "Quantized",
           "qNormal", "qUniform"]

_FLOOR = 1e-12


def _log_floor(p):
  # the floor made on p's device (no host copy: a CUDA graph captures it)
  return torch.log(torch.maximum(p, p.new_full((), _FLOOR)))


class QuantizedLogistic(Distribution):
  """The logistic CDF integrated over the integer bins of [low, high].
  With ``inputs_domain='sigmoid'`` the data lie in [0, 1] and are mapped
  onto the grid (``x * (high - low) + low``) before the bins are read, and
  samples and the mean are mapped back."""
  _params = ("loc", "scale")

  def __init__(self, loc, scale, low: int = 0, high: int = 255,
               inputs_domain: str = "sigmoid"):
    self.loc = _float(loc)
    self.scale = _float(scale)
    self.low = int(low)
    self.high = int(high)
    self.inputs_domain = inputs_domain

  @property
  def batch_shape(self):
    return torch.broadcast_shapes(self.loc.shape, self.scale.shape)

  def _to_grid(self, x):
    if self.inputs_domain == "sigmoid":
      return x * (self.high - self.low) + self.low
    return x

  def _from_grid(self, x):
    if self.inputs_domain == "sigmoid":
      return (x - self.low) / (self.high - self.low)
    return x

  def _quantize(self, base):
    return self._from_grid(torch.clamp(torch.round(base), self.low,
                                       self.high))

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self._quantize(Logistic(self.loc, self.scale).sample(
        sample_shape, generator, eps))

  def sample_from(self, noise, sample_shape=()):
    return self._quantize(Logistic(self.loc, self.scale).sample_from(
        noise, sample_shape))

  def log_prob(self, x):
    x = self._to_grid(x)
    base = Logistic(self.loc, self.scale)
    mid = _log_floor(base.cdf(x + 0.5) - base.cdf(x - 0.5))
    log_low = base.log_cdf(x + 0.5)
    log_high = _log_floor(1.0 - base.cdf(x - 0.5))
    return torch.where(x <= self.low, log_low,
                       torch.where(x >= self.high, log_high, mid))

  def mean(self):
    return self._from_grid(self.loc.expand(self.batch_shape))

  def mode(self):
    return self.mean()

  def variance(self):
    v = ((self.scale * math.pi) ** 2 / 3.0).expand(self.batch_shape)
    return v / ((self.high - self.low) ** 2
                if self.inputs_domain == "sigmoid" else 1.0)


def MixtureQuantizedLogistic(logits, locs, scales, low: int = 0,
                             high: int = 255,
                             inputs_domain: str = "sigmoid"
                             ) -> MixtureSameFamily:
  """K quantized logistics mixed by `logits` (the PixelCNN++
  likelihood)."""
  return MixtureSameFamily(
      Categorical(logits=logits),
      QuantizedLogistic(locs, scales, low=low, high=high,
                        inputs_domain=inputs_domain))


class Quantized(Distribution):
  """A continuous base (with ``cdf``) rounded to integers: ``P(X = j) =
  cdf(j + .5) - cdf(j - .5)``, the tails folded into the `low`/`high`
  edge bins where given."""

  def __init__(self, distribution: Distribution, low=None, high=None):
    self.distribution = distribution
    self.low = low
    self.high = high

  @property
  def batch_shape(self):
    return self.distribution.batch_shape

  @property
  def event_shape(self):
    return self.distribution.event_shape

  @property
  def dtype(self):
    return self.distribution.dtype

  def _quantize(self, x):
    x = torch.round(x)
    if self.low is not None:
      x = torch.clamp(x, min=self.low)
    if self.high is not None:
      x = torch.clamp(x, max=self.high)
    return x

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self._quantize(self.distribution.sample(sample_shape, generator,
                                                   eps))

  def sample_from(self, noise, sample_shape=()):
    return self._quantize(self.distribution.sample_from(noise,
                                                        sample_shape))

  def log_prob(self, x):
    base = self.distribution
    out = _log_floor(base.cdf(x + 0.5) - base.cdf(x - 0.5))
    if self.low is not None:
      out = torch.where(x <= self.low, _log_floor(base.cdf(x + 0.5)), out)
    if self.high is not None:
      out = torch.where(x >= self.high, _log_floor(1.0 - base.cdf(x - 0.5)),
                        out)
    return out

  def mean(self):
    return self.distribution.mean()

  def mode(self):
    return torch.round(self.distribution.mode())


class qNormal(Quantized):
  """A quantized ``Normal``."""

  def __init__(self, loc=0.0, scale=1.0, min_value=None, max_value=None):
    super().__init__(Normal(_float(loc), _float(scale)), low=min_value,
                     high=max_value)


class qUniform(Quantized):
  """A quantized ``Uniform``."""

  def __init__(self, low=0.0, high=1.0, min_value=None, max_value=None):
    super().__init__(Uniform(low, high), low=min_value, high=max_value)
