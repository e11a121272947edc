"""Distribution utility layers (PyTorch port of
``odin_tpu/bay/layers/util_layers.py:24-93``): ``Sampling``, ``Moments``,
``Stddev``, ``DistributionAttr`` and ``ConditionalTensorLayer``, which
turn a distribution back into tensors (or, the last, condition it)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from odin_tpu_torch.bay.distributions import ConditionalTensor, Distribution
from odin_tpu_torch.networks.base import layer_noise

__all__ = ["Sampling", "Moments", "Stddev", "DistributionAttr",
           "ConditionalTensorLayer"]


class _Stateless(nn.Module):

  def build(self, in_shape, generator=None):
    return in_shape


class Sampling(_Stateless):
  """`sample_shape` samples of an input distribution, drawn from the
  step's noise (``layer_noise``) inside a model's step, else from
  `generator`; a tensor is passed through with the sample dims
  prepended."""

  def __init__(self, sample_shape: Tuple[int, ...] = (),
               generator: Optional[torch.Generator] = None):
    super().__init__()
    self.sample_shape = tuple(int(i) for i in sample_shape)
    self.generator = generator

  def forward(self, x):
    if isinstance(x, Distribution):
      noise = layer_noise()
      if noise is not None:
        return x.sample_from(noise, self.sample_shape)
      return x.sample(self.sample_shape, generator=self.generator)
    for _ in range(len(self.sample_shape)):
      x = x.unsqueeze(0)
    return x


class Moments(_Stateless):
  """The mean and/or variance of a distribution; a tensor passes
  through."""

  def __init__(self, mean: bool = True, variance: bool = True):
    super().__init__()
    assert mean or variance, "must return mean or variance"
    self.mean = bool(mean)
    self.variance = bool(variance)

  def forward(self, x):
    if not isinstance(x, Distribution):
      return x
    out = []
    if self.mean:
      out.append(x.mean())
    if self.variance:
      out.append(x.variance())
    return out[0] if len(out) == 1 else tuple(out)


class Stddev(_Stateless):
  """The standard deviation of a distribution; a tensor passes through."""

  def forward(self, x):
    return x.stddev() if isinstance(x, Distribution) else x


class DistributionAttr(_Stateless):
  """A dotted attribute of a distribution, e.g.
  ``'distribution.concentration'``; a method on the way (``mean``,
  ``stddev``) is called."""

  def __init__(self, attr_name: str = "mean"):
    super().__init__()
    self.attr_name = attr_name

  def forward(self, x):
    for name in self.attr_name.split("."):
      x = getattr(x, name)
      if callable(x) and not isinstance(x, Distribution):
        x = x()
    return x


class ConditionalTensorLayer(_Stateless):
  """``(distribution, tensor) -> ConditionalTensor``: the conditional
  VAE's helper, whose samples and means carry the tensor appended while
  its densities and KL ignore it."""

  def forward(self, inputs):
    dist, tensor = inputs
    assert isinstance(dist, Distribution), dist
    return ConditionalTensor(dist, torch.as_tensor(tensor))
