"""VariationalModel: the ELBO configuration and estimators every
variational model carries (PyTorch port of ``odin_tpu/bay/vi/_base.py``:
``traverse_dims``, ``elbo``, ``importance_weighted``, ``perplexity`` and
``_schedule``)."""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from odin_tpu_torch.backend.interpolation import Interpolation

__all__ = ["VariationalModel", "traverse_dims"]


def _sum_dict(d: Dict[str, torch.Tensor]) -> torch.Tensor:
  vals = list(d.values())
  out = vals[0]
  for v in vals[1:]:
    out = out + v
  return out


def traverse_dims(z: torch.Tensor,
                  feature_indices: Optional[Sequence[int]] = None,
                  min_val: float = -2.0,
                  max_val: float = 2.0,
                  n_traverse_points: int = 11,
                  mode: str = "linear") -> torch.Tensor:
  """Tile `z` (B, zdim) and sweep each selected latent dimension across
  [min_val, max_val] ('linear') or across the quantiles of z
  ('quantile'): (n_points * n_indices * B, zdim), ordered as [dim0's
  sweep..., dim1's sweep...]."""
  z = torch.as_tensor(z)
  if z.ndim == 1:
    z = z[None]
  zdim = z.shape[-1]
  if feature_indices is None:
    feature_indices = list(range(zdim))
  if mode == "linear":
    pts = torch.linspace(min_val, max_val, n_traverse_points,
                         dtype=z.dtype, device=z.device)
  elif mode == "quantile":
    pts = torch.quantile(z.reshape(-1), torch.linspace(
        0.0, 1.0, n_traverse_points, dtype=z.dtype, device=z.device))
  else:
    raise ValueError(f"unknown traverse mode {mode}")
  outs = []
  for idx in feature_indices:
    tiled = z[None].repeat(n_traverse_points, 1, 1)  # (P, B, zdim)
    tiled[:, :, idx] = pts[:, None]
    outs.append(tiled.reshape(-1, zdim))
  return torch.cat(outs, dim=0)


class VariationalModel:
  """Base for variational models: ELBO hyperparameters and estimators."""

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

  @classmethod
  def is_semi_supervised(cls) -> bool:
    """Whether the model trains on (x, y[, mask]) batches; the
    semi-supervised families override it."""
    return False

  def elbo(self, llk: Dict[str, torch.Tensor],
           kl: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``sum(llk) - sum(kl)``, elementwise over the batch."""
    total_llk = _sum_dict(llk) if llk else torch.zeros(())
    total_kl = _sum_dict(kl) if kl else torch.zeros(())
    return total_llk - total_kl

  @staticmethod
  def importance_weighted(elbo_samples: torch.Tensor,
                          axis: int = 0) -> torch.Tensor:
    """IWAE bound: log-mean-exp over the sample axis."""
    n = elbo_samples.shape[axis]
    return torch.logsumexp(elbo_samples, dim=axis) - math.log(float(n))

  @staticmethod
  def perplexity(log_likelihood: torch.Tensor,
                 n_words: torch.Tensor) -> torch.Tensor:
    """``exp(-llk / n_words)``."""
    return torch.exp(-log_likelihood / torch.clamp(torch.as_tensor(n_words),
                                                   min=1.0))

  @staticmethod
  def _schedule(value, step) -> torch.Tensor:
    """A coefficient at `step`: an ``Interpolation`` is called on the step
    (a device tensor stays on its device, with no sync), a number becomes a
    0-d float32 tensor."""
    if isinstance(value, Interpolation):
      return value(step)
    return torch.tensor(value, dtype=torch.float32)
