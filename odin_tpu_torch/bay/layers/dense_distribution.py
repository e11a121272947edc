"""Distribution heads of the port (PyTorch port of
``odin_tpu/bay/layers/dense_distribution.py``): ``DistributionDense`` :28
with its autoregressive and dropout branches (:43-61), the mixture heads
``MixtureDensityNetwork`` :92 and ``MixtureMassNetwork`` :106,
``DenseDeterministic`` :123, the latent shortcuts :130-156,
``merge_normal``/``MergeNormal`` :157-179 and ``DistributionNetwork``
:180."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from odin_tpu_torch.bay.distribution_alias import DistSpec, parse_distribution
from odin_tpu_torch.bay.distributions import Distribution, Normal
from odin_tpu_torch.networks.base import Dense, Dropout

__all__ = ["DistributionDense", "MixtureDensityNetwork", "MixtureMassNetwork",
           "DenseDeterministic", "NormalLatents", "MVNDiagLatents",
           "MixtureNormalLatents", "MixtureMVNDiagLatents", "merge_normal",
           "MergeNormal", "DistributionNetwork"]


class DistributionDense(nn.Module):
  """Dense(params_size) -> distribution builder.  With ``projection=False``
  the input already holds the raw params; with `autoregressive` the
  projection is a MADE network (``AutoregressiveDense``, one hidden layer
  of params_size units) whose parameters of event dim i see only the
  inputs of degree below i + 1; `dropout` drops raw params in training
  mode, as flax's ``Dropout`` (uniforms from the step's noise).  `name`
  names the head's terms in a VAE's metrics (``llk_<name>``,
  ``kl_<name>``)."""

  default_posterior = "normal"

  def __init__(self, event_shape: Sequence[int] = (),
               posterior: Optional[str] = None,
               posterior_kwargs: Optional[Dict[str, Any]] = None,
               projection: bool = True, dropout: float = 0.0,
               use_bias: bool = True, autoregressive: bool = False,
               name: Optional[str] = None):
    super().__init__()
    self.name = name
    self.event_shape = tuple(int(i) for i in event_shape)
    self.posterior = posterior or self.default_posterior
    self.posterior_kwargs = dict(posterior_kwargs or {})
    self.dropout = float(dropout)
    self.autoregressive = bool(autoregressive)
    if not projection:
      self.projection = None
    elif autoregressive:
      from odin_tpu_torch.bay.layers.autoregressive import AutoregressiveDense
      per_dim = self.params_size // self.event_size
      if per_dim * self.event_size != self.params_size:
        raise ValueError(
            f"autoregressive head needs params_size divisible by "
            f"event_size ({self.params_size} / {self.event_size})")
      self.projection = AutoregressiveDense(
          params=per_dim, event_size=self.event_size,
          hidden_units=(self.params_size,), use_bias=use_bias)
    else:
      self.projection = Dense(self.params_size, use_bias=use_bias, bare=True)
    self.drop = Dropout(self.dropout) if self.dropout > 0 else None

  @property
  def spec(self) -> DistSpec:
    return parse_distribution(self.posterior)

  @property
  def event_size(self) -> int:
    return int(np.prod(self.event_shape)) if len(self.event_shape) else 1

  @property
  def params_size(self) -> int:
    return int(self.spec.params_size(self.event_size, **self.posterior_kwargs))

  @property
  def prior(self) -> Optional[Distribution]:
    return self.spec.default_prior(self.event_shape, **self.posterior_kwargs)

  def build(self, in_shape, generator=None):
    if self.projection is not None:
      self.projection.build(in_shape, generator)
    return self.event_shape

  def forward(self, x) -> Distribution:
    params = self.projection(x) if self.projection is not None else x
    if self.drop is not None:
      params = self.drop(params)
    return self.spec.builder(params, self.event_shape, **self.posterior_kwargs)


class MixtureDensityNetwork(DistributionDense):
  """A Gaussian-mixture head; ``create(units, n_components, covariance)``
  picks 'gmmdiag' or 'gmmtril'."""

  default_posterior = "gmmdiag"

  @classmethod
  def create(cls, units: int, n_components: int = 2,
             covariance: str = "diag", **kwargs):
    alias = {"diag": "gmmdiag", "none": "gmmdiag", "tril": "gmmtril",
             "full": "gmmtril"}[covariance]
    return cls(event_shape=(int(units),), posterior=alias,
               posterior_kwargs={"n_components": int(n_components)},
               **kwargs)


class MixtureMassNetwork(DistributionDense):
  """A mixture of mean/dispersion negative binomials for counts (scVI's
  heads); ``create(units, n_components, zero_inflated, mean_activation)``
  picks 'mixnb' or 'mixzinb'."""

  default_posterior = "mixnb"

  @classmethod
  def create(cls, units: int, n_components: int = 2,
             zero_inflated: bool = False,
             mean_activation: str = "softplus", **kwargs):
    return cls(event_shape=(int(units),),
               posterior="mixzinb" if zero_inflated else "mixnb",
               posterior_kwargs={"n_components": int(n_components),
                                 "mean_activation": mean_activation},
               **kwargs)


class DenseDeterministic(DistributionDense):
  """A point-mass head, the autoencoder's baseline."""

  default_posterior = "vdeterministic"


class NormalLatents(DistributionDense):
  """An Independent-Normal latent head."""

  default_posterior = "normal"


class MVNDiagLatents(DistributionDense):
  """An MVN-diag latent head."""

  default_posterior = "mvndiag"


class MixtureNormalLatents(MixtureDensityNetwork):
  """A Gaussian-mixture latent head (``create(units, n_components)``)."""

  default_posterior = "gmmdiag"


class MixtureMVNDiagLatents(MixtureDensityNetwork):
  """A Gaussian-mixture latent head of diagonal-covariance components."""

  default_posterior = "gmmdiag"


def merge_normal(q_e: Distribution, q_d: Distribution) -> Normal:
  """The precision-weighted merge of two factorised Gaussians, the ladder
  VAE's posterior (Sønderby et al. 2016): precision ``1/var_e + 1/var_d``,
  mean ``(mu_e/var_e + mu_d/var_d) / precision``."""
  var_e, var_d = q_e.variance(), q_d.variance()
  prec = 1.0 / var_e + 1.0 / var_d
  loc = (q_e.mean() / var_e + q_d.mean() / var_d) / prec
  return Normal(loc, torch.sqrt(1.0 / prec))


class MergeNormal(nn.Module):
  """``merge_normal`` as a layer on a pair of distributions."""

  def build(self, in_shape, generator=None):
    return in_shape

  def forward(self, dists):
    q_e, q_d = dists
    return merge_normal(q_e, q_d)


class DistributionNetwork(nn.Module):
  """A trunk network and one or more distribution heads on its output:
  one distribution per head (the distribution itself for one head)."""

  def __init__(self, network: nn.Module, distributions: Sequence[nn.Module]):
    super().__init__()
    self.network = network
    self.distributions = nn.ModuleList(distributions)

  def build(self, in_shape, generator=None):
    h = self.network.build(tuple(in_shape), generator)
    return tuple(head.build(h, generator) for head in self.distributions)

  def forward(self, x):
    h = self.network(x)
    outs = tuple(head(h) for head in self.distributions)
    return outs[0] if len(outs) == 1 else outs
