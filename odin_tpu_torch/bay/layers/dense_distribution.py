"""DistributionDense: optional Dense(params_size) projection -> Distribution
(PyTorch port of ``odin_tpu/bay/layers/dense_distribution.py:28-89``)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
from torch import nn

from odin_tpu_torch.bay.distribution_alias import DistSpec, parse_distribution
from odin_tpu_torch.bay.distributions import Distribution
from odin_tpu_torch.networks.base import Dense

__all__ = ["DistributionDense"]


class DistributionDense(nn.Module):
  """Dense(params_size) -> distribution builder.  With ``projection=False``
  the input already holds the raw params.  `name` names the head's terms
  in a VAE's metrics (``llk_<name>``, ``kl_<name>``)."""

  def __init__(self, event_shape: Sequence[int] = (), posterior: str = "normal",
               posterior_kwargs: Optional[Dict[str, Any]] = None,
               projection: bool = True, use_bias: bool = True,
               name: Optional[str] = None):
    super().__init__()
    self.name = name
    self.event_shape = tuple(int(i) for i in event_shape)
    self.posterior = posterior
    self.posterior_kwargs = dict(posterior_kwargs or {})
    self.projection = (Dense(self.params_size, use_bias=use_bias, bare=True)
                       if projection else None)

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
    return self.spec.builder(params, self.event_shape, **self.posterior_kwargs)
