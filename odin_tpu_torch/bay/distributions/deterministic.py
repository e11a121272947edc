"""Point masses of the port (PyTorch port of ``Deterministic`` and
``VectorDeterministic``, ``odin_tpu/bay/distributions/deterministic.py:20,
58``): the latents of the deterministic autoencoders (``Autoencoder``,
``irmAE``) and the heads of ``DistEncoder``."""
from __future__ import annotations

import torch

from odin_tpu_torch.bay.distributions.base import Distribution

__all__ = ["Deterministic", "VectorDeterministic"]


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
