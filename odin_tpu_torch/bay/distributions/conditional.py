"""``ConditionalTensor`` of the port (PyTorch port of
``odin_tpu/bay/distributions/conditional.py:18``, KL :108): a
distribution whose samples and point statistics carry a conditioning
tensor (one-hot labels, say) appended on the event axis, so that a
conditional decoder sees ``[z, y]``, while its densities and KL are the
wrapped distribution's."""
from __future__ import annotations

import torch

from odin_tpu_torch.bay.distributions.base import (Distribution, exact_kl,
                                                   register_kl)

__all__ = ["ConditionalTensor"]


class ConditionalTensor(Distribution):
  """`distribution` with `conditional_tensor` appended on the last axis of
  ``sample``/``mean``/``mode``/``variance``/``stddev``.  ``log_prob`` and
  ``entropy`` are the wrapped distribution's: an ``x`` with the full
  concatenated event has the conditioning slice stripped first."""

  def __init__(self, distribution: Distribution, conditional_tensor):
    self.distribution = distribution
    self.conditional_tensor = torch.as_tensor(conditional_tensor)

  @property
  def batch_shape(self):
    return self.distribution.batch_shape

  @property
  def event_shape(self):
    ev = tuple(self.distribution.event_shape)
    base = ev[-1] if ev else 1
    return ev[:-1] + (base + self.conditional_tensor.shape[-1],)

  @property
  def dtype(self):
    return self.distribution.dtype

  def _base_event_dim(self) -> int:
    ev = tuple(self.distribution.event_shape)
    return ev[-1] if ev else 1

  def _concat(self, x):
    t = self.conditional_tensor.to(device=x.device, dtype=x.dtype).expand(
        tuple(x.shape[:-1]) + tuple(self.conditional_tensor.shape[-1:]))
    return torch.cat([x, t], dim=-1)

  def _with_event(self, v):
    return v if self.distribution.event_shape else v[..., None]

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self._concat(self._with_event(
        self.distribution.sample(sample_shape, generator, eps)))

  def sample_from(self, noise, sample_shape=()):
    return self._concat(self._with_event(
        self.distribution.sample_from(noise, sample_shape)))

  def log_prob(self, x):
    x = torch.as_tensor(x)
    if x.shape[-1] == self.event_shape[-1]:
      x = x[..., :self._base_event_dim()]
    if not self.distribution.event_shape:
      x = x.squeeze(-1)
    return self.distribution.log_prob(x)

  def _stat(self, name):
    return self._concat(self._with_event(
        getattr(self.distribution, name)()))

  def mean(self):
    return self._stat("mean")

  def mode(self):
    return self._stat("mode")

  def variance(self):
    return self._stat("variance")

  def stddev(self):
    return self._stat("stddev")

  def entropy(self):
    return self.distribution.entropy()

  def __repr__(self):
    return (f"ConditionalTensor({self.distribution!r}, "
            f"tensor={tuple(self.conditional_tensor.shape)})")


@register_kl(ConditionalTensor, ConditionalTensor)
def _kl_conditional(q: ConditionalTensor, p: ConditionalTensor):
  # the conditioning tensor is observed: the KL is the latents'
  return exact_kl(q.distribution, p.distribution)
