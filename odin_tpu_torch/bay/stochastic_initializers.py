"""Stochastic (variational) weights of the port (PyTorch port of
``odin_tpu/bay/stochastic_initializers.py:20-111``): ``TrainableNormal``
and ``TrainableNormalSharedScale``, variables that are distributions of
trainable parameters, the initializer ``trainable_normal_init``, and
``VariationalDense``, a Dense layer with a factorised-Gaussian posterior
over its kernel (Bayes by backprop).  They hold their parameters under
flax's names and layouts (``flax_raw``: ``loc``/``scale``,
``kernel_mu``/``kernel_rho``/``bias``, kernels (in, out))."""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from odin_tpu_torch.bay.distributions import Independent, Normal
from odin_tpu_torch.networks.base import _variance_scaling_, layer_noise

__all__ = ["trainable_normal_init", "VariationalDense", "StochasticVariable",
           "TrainableNormal", "TrainableNormalSharedScale",
           "trainable_normal", "trainable_normal_shared_scale"]


def trainable_normal_init(mean: float = 0.0, stddev: float = 0.05
                          ) -> Callable:
  """An initializer ``init(generator, shape, dtype)`` drawing
  N(mean, stddev²)."""

  def init(generator, shape, dtype=torch.float32):
    return mean + stddev * torch.randn(tuple(shape), generator=generator,
                                       dtype=dtype)

  return init


class StochasticVariable(nn.Module):
  """A variable that is a distribution: calling it returns the
  distribution its parameters make; `sample_shape` is ``sample``'s
  default."""

  flax_raw = True

  def __init__(self, sample_shape: Tuple[int, ...] = ()):
    super().__init__()
    self.sample_shape = tuple(sample_shape)

  def distribution(self):
    raise NotImplementedError

  def forward(self):
    return self.distribution()


class TrainableNormal(StochasticVariable):
  """A factorised Normal of trainable ``loc`` (drawn from N(0,
  `loc_init_stddev`²)) and ``scale`` (softplus of a raw value, `scale_init`
  at first; one scalar with `shared_scale`)."""

  def __init__(self, shape: Tuple[int, ...] = (),
               loc_init_stddev: float = 0.05, scale_init: float = -2.0,
               shared_scale: bool = False,
               sample_shape: Tuple[int, ...] = ()):
    super().__init__(sample_shape)
    self.shape = tuple(int(i) for i in shape)
    self.loc_init_stddev = float(loc_init_stddev)
    self.scale_init = float(scale_init)
    self.shared_scale = bool(shared_scale)

  def build(self, in_shape=None, generator=None):
    self.loc = nn.Parameter(trainable_normal_init(
        0.0, self.loc_init_stddev)(generator, self.shape))
    self.scale = nn.Parameter(torch.full(
        () if self.shared_scale else self.shape, self.scale_init))
    return self.shape

  def distribution(self):
    scale = F.softplus(self.scale).expand(self.shape)
    return Independent(Normal(self.loc, scale), max(len(self.shape), 1))

  def sample(self, generator: Optional[torch.Generator] = None,
             sample_shape=None):
    return self.distribution().sample(
        self.sample_shape if sample_shape is None else sample_shape,
        generator=generator)


class TrainableNormalSharedScale(TrainableNormal):
  """``TrainableNormal`` with one scale shared by every element."""

  def __init__(self, shape: Tuple[int, ...] = (), **kwargs):
    kwargs.setdefault("shared_scale", True)
    super().__init__(shape, **kwargs)


trainable_normal = TrainableNormal
trainable_normal_shared_scale = TrainableNormalSharedScale


class VariationalDense(nn.Module):
  """``x @ kernel + bias`` with ``kernel ~ N(kernel_mu,
  softplus(kernel_rho)²)`` drawn anew each training call from the step's
  noise (``layer_noise``; the posterior mean in eval mode).
  ``kernel_kl()`` is the weights' KL to a N(0, `prior_scale`²) prior, the
  value the JAX layer sows into its ``losses`` collection."""

  flax_raw = True

  def __init__(self, features: int, prior_scale: float = 1.0):
    super().__init__()
    self.features = int(features)
    self.prior_scale = float(prior_scale)

  def build(self, in_shape, generator=None):
    d = int(in_shape[-1])
    mu = torch.empty(self.features, d)
    _variance_scaling_(mu, 1.0, d, generator)  # lecun_normal
    self.kernel_mu = nn.Parameter(mu.T.contiguous())
    self.kernel_rho = nn.Parameter(torch.full((d, self.features), -5.0))
    self.bias = nn.Parameter(torch.zeros(self.features))
    return tuple(in_shape[:-1]) + (self.features,)

  def kernel_kl(self) -> torch.Tensor:
    sigma = F.softplus(self.kernel_rho)
    s = self.prior_scale
    return torch.sum(torch.log(s / sigma) +
                     (sigma ** 2 + self.kernel_mu ** 2) / (2 * s ** 2) - 0.5)

  def forward(self, x):
    kernel = self.kernel_mu
    if self.training:
      noise = layer_noise()
      if noise is None:
        raise RuntimeError("VariationalDense in training mode draws from "
                           "the step's noise: call it through a step")
      eps = noise.normal(tuple(kernel.shape), kernel.dtype, kernel.device)
      kernel = kernel + F.softplus(self.kernel_rho) * eps
    return x @ kernel + self.bias
