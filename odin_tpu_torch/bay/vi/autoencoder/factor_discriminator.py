"""FactorVAE's discriminator (PyTorch port of
``odin_tpu/bay/vi/autoencoder/factor_discriminator.py:22-67``): the MLP
D(z), its TC logit, and the total-correlation and discriminator losses on
raw logits."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from odin_tpu_torch.networks.base import BatchNorm, Dense, get_activation

__all__ = ["FactorDiscriminator", "total_correlation_logits",
           "dtc_loss_logits"]


class FactorDiscriminator(nn.Module):
  """MLP discriminator D(z): ``Dense_i`` layers of `units` (each followed
  by ``BatchNorm_i`` and the activation with `batchnorm`), then a Dense of
  `n_outputs` logits; the first is the real-against-permuted logit, any
  others (semi-supervised) are label logits that `ss_strategy` reduces for
  the TC estimate.  The submodules carry flax's auto names, so the
  weight bridge maps them as they are."""

  def __init__(self, units: Sequence[int] = (1000,) * 5,
               activation: str = "relu", batchnorm: bool = False,
               n_outputs: int = 1, ss_strategy: str = "logsumexp"):
    super().__init__()
    self.units = tuple(int(u) for u in units)
    self.activation = activation
    self.batchnorm = bool(batchnorm)
    self.n_outputs = int(n_outputs)
    self.ss_strategy = ss_strategy
    for i, u in enumerate(self.units):
      self.add_module(f"Dense_{i}", Dense(u, activation=None if batchnorm
                                          else activation))
      if self.batchnorm:
        self.add_module(f"BatchNorm_{i}", BatchNorm())
    self.add_module(f"Dense_{len(self.units)}", Dense(self.n_outputs))

  def build(self, in_shape, generator=None):
    shape = tuple(in_shape)
    for layer in self.children():
      shape = layer.build(shape, generator)
    return shape

  def forward(self, z):
    h = z
    act = get_activation(self.activation)
    for i in range(len(self.units)):
      h = getattr(self, f"Dense_{i}")(h)
      if self.batchnorm:
        h = act(getattr(self, f"BatchNorm_{i}")(h))
    return getattr(self, f"Dense_{len(self.units)}")(h)

  def tc_logits(self, logits: torch.Tensor) -> torch.Tensor:
    """Multi-output logits reduced to the single TC logit."""
    if self.n_outputs == 1:
      return logits[..., 0]
    red = {"sum": torch.sum, "mean": torch.mean, "max": torch.amax,
           "min": torch.amin, "logsumexp": torch.logsumexp}[self.ss_strategy]
    return red(logits, dim=-1)


def total_correlation_logits(tc_logit: torch.Tensor) -> torch.Tensor:
  """TC(z) ~ E_q(z)[log D(z) - log(1 - D(z))]: the mean raw logit."""
  return torch.mean(tc_logit)


def dtc_loss_logits(z_logit: torch.Tensor,
                    zperm_logit: torch.Tensor) -> torch.Tensor:
  """The discriminator's loss (Kim & Mnih 2018, Algorithm 2), real codes
  labelled 1 and permuted codes 0: ``0.5 (mean softplus(-D(z)) + mean
  softplus(D(z~)))``."""
  return 0.5 * (torch.mean(F.softplus(-z_logit)) +
                torch.mean(F.softplus(zperm_logit)))
