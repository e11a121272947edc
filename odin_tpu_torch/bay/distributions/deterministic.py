"""Point masses of the port (PyTorch port of ``Deterministic`` and
``VectorDeterministic``, ``odin_tpu/bay/distributions/deterministic.py:20,
58``): the latents of the deterministic autoencoders (``Autoencoder``,
``irmAE``) and the heads of ``DistEncoder``; and ``Batchwise`` (:73), a
list of distributions concatenated along a batch axis."""
from __future__ import annotations

from typing import Sequence

import torch

from odin_tpu_torch.bay.distributions.base import Distribution

__all__ = ["Deterministic", "VectorDeterministic", "Batchwise"]


class Deterministic(Distribution):
  """A point mass at `loc`; ``log_prob`` is 0 within `atol` of it, else
  -inf.  Sampling makes no draw."""
  _params = ("loc",)

  def __init__(self, loc, atol: float = 0.0):
    self.loc = torch.as_tensor(loc)
    self.atol = float(atol)

  @property
  def batch_shape(self):
    return self.loc.shape

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self.loc.expand(tuple(sample_shape) + tuple(self.loc.shape))

  def sample_from(self, noise, sample_shape=()):
    return self.sample(sample_shape)

  def _log_prob(self, eq):
    return torch.where(eq, torch.zeros((), dtype=self.loc.dtype,
                                       device=self.loc.device),
                       torch.full((), -float("inf"), dtype=self.loc.dtype,
                                  device=self.loc.device))

  def log_prob(self, x):
    return self._log_prob(torch.abs(x - self.loc) <= self.atol)

  def mean(self):
    return self.loc

  def mode(self):
    return self.loc

  def variance(self):
    return torch.zeros_like(self.loc)

  def entropy(self):
    return torch.zeros(self.batch_shape, dtype=self.loc.dtype,
                       device=self.loc.device)


class VectorDeterministic(Deterministic):
  """A point mass whose last axis is the event."""

  @property
  def batch_shape(self):
    return self.loc.shape[:-1]

  @property
  def event_shape(self):
    return self.loc.shape[-1:]

  def log_prob(self, x):
    return self._log_prob(torch.all(torch.abs(x - self.loc) <= self.atol,
                                    dim=-1))


class Batchwise(Distribution):
  """Same-family distributions concatenated along the batch axis `axis`:
  each statistic is each part's, concatenated (a host-side container for
  evaluation sweeps, as in the JAX package).  A sample draws each part's
  in turn (``eps``, where given, is a list of each part's)."""

  def __init__(self, distributions: Sequence[Distribution], axis: int = 0):
    self.distributions = tuple(distributions)
    self.axis = int(axis)

  @property
  def batch_shape(self):
    shapes = [tuple(d.batch_shape) for d in self.distributions]
    out = list(shapes[0])
    out[self.axis] = sum(s[self.axis] for s in shapes)
    return tuple(out)

  @property
  def event_shape(self):
    return tuple(self.distributions[0].event_shape)

  @property
  def dtype(self):
    return self.distributions[0].dtype

  def _split(self, x):
    sizes = [d.batch_shape[self.axis] for d in self.distributions]
    axis = self.axis if self.axis >= 0 else \
        x.ndim - len(self.event_shape) + self.axis
    return torch.split(x, sizes, dim=axis)

  def _cat(self, parts, sample_ndim: int = 0):
    return torch.cat(list(parts), dim=self.axis + sample_ndim
                     if self.axis >= 0 else self.axis)

  def sample(self, sample_shape=(), generator=None, eps=None):
    eps = eps if eps is not None else [None] * len(self.distributions)
    return self._cat([d.sample(sample_shape, generator, e)
                      for d, e in zip(self.distributions, eps)],
                     len(tuple(sample_shape)))

  def sample_from(self, noise, sample_shape=()):
    return self._cat([d.sample_from(noise, sample_shape)
                      for d in self.distributions], len(tuple(sample_shape)))

  def log_prob(self, x):
    return self._cat([d.log_prob(p) for d, p in
                      zip(self.distributions, self._split(x))])

  def mean(self):
    return self._cat([d.mean() for d in self.distributions])

  def mode(self):
    return self._cat([d.mode() for d in self.distributions])

  def variance(self):
    return self._cat([d.variance() for d in self.distributions])

  def kl_divergence(self, other, **kwargs):
    """Each part's KL to the matching part of `other` (a Batchwise) or to
    `other` itself, concatenated."""
    if isinstance(other, Batchwise):
      pairs = zip(self.distributions, other.distributions)
    else:
      pairs = ((q, other) for q in self.distributions)
    return self._cat([q.kl_divergence(p, **kwargs) for q, p in pairs])
