"""VariationalModel: the ELBO configuration every variational model carries
(PyTorch port of the constructor of ``odin_tpu/bay/vi/_base.py:66-119``;
the estimators come with the training slice)."""
from __future__ import annotations

from typing import Optional, Tuple, Union

__all__ = ["VariationalModel"]


class VariationalModel:
  """Base for variational models: ELBO hyperparameters."""

  def __init__(self,
               analytic: bool = False,
               reverse: bool = True,
               free_bits: Optional[float] = None,
               sample_shape: Union[int, Tuple[int, ...]] = (),
               allow_negative_kl: bool = True,
               name: Optional[str] = None):
    self.analytic = bool(analytic)
    self.reverse = bool(reverse)
    self.free_bits = free_bits
    if isinstance(sample_shape, int):
      sample_shape = (sample_shape,) if sample_shape > 1 else ()
    self.sample_shape = tuple(sample_shape)
    self.allow_negative_kl = bool(allow_negative_kl)
    self.name = name or type(self).__name__.lower()
