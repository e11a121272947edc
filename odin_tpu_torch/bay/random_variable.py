"""RVconf: declarative random-variable descriptor (PyTorch port of
``odin_tpu/bay/random_variable.py:22``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np

from odin_tpu_torch.bay.distribution_alias import parse_distribution
from odin_tpu_torch.bay.distributions import Distribution

__all__ = ["RVconf"]


@dataclasses.dataclass
class RVconf:
  """Descriptor for a random-variable head, e.g.
  ``RVconf(10, 'mvndiag', projection=True, name='latents')``.  The fields
  are the JAX package's, in its order: `autoregressive` makes the head's
  projection a MADE network, `dropout` drops its raw parameters in
  training."""

  event_shape: Union[int, Sequence[int]] = ()
  posterior: str = "normal"
  projection: bool = True
  autoregressive: bool = False
  dropout: float = 0.0
  name: str = "variable"
  prior: Optional[Distribution] = None
  kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

  def __post_init__(self):
    if isinstance(self.event_shape, (int, np.integer)):
      self.event_shape = (int(self.event_shape),)
    else:
      self.event_shape = tuple(int(i) for i in self.event_shape)

  def copy(self, **overrides) -> "RVconf":
    """A copy with some fields replaced."""
    data = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
    data["kwargs"] = dict(self.kwargs)
    data.update(overrides)
    return RVconf(**data)

  @property
  def event_size(self) -> int:
    return int(np.prod(self.event_shape)) if len(self.event_shape) else 1

  @property
  def params_size(self) -> int:
    spec = parse_distribution(self.posterior)
    return int(spec.params_size(self.event_size, **self.kwargs))

  def create_posterior(self, name: Optional[str] = None):
    """The ``DistributionDense`` head of this variable, named `name` (the
    variable's own name by default)."""
    # imported here: the head depends on the network layers, whose package
    # imports this module through the image networks
    from odin_tpu_torch.bay.layers.dense_distribution import DistributionDense
    return DistributionDense(event_shape=self.event_shape,
                             posterior=self.posterior,
                             posterior_kwargs=dict(self.kwargs),
                             projection=self.projection,
                             autoregressive=self.autoregressive,
                             dropout=self.dropout,
                             name=name or self.name)

  def create_prior(self) -> Optional[Distribution]:
    if self.prior is not None:
      return self.prior
    spec = parse_distribution(self.posterior)
    return spec.default_prior(self.event_shape, **self.kwargs)
