"""Structured dropout of the port (PyTorch port of
``odin_tpu/networks/dropout.py``: ``DiscreteDropout`` :24 and ``DropBlock``
:58).  Both are the identity in eval mode.

Their draws come from `rng`, a ``torch.Generator`` or a
``training.core.Noise`` (whose injected draws a test fills with the JAX
package's), else from the step's noise (``base.layer_noise``).  A
Bernoulli draw is a uniform compared with its probability, as
``jax.random.bernoulli`` makes it, so the uniforms of the JAX package give
the same masks; the Binomial thinning draws with ``torch.binomial`` (one
``Noise.draw``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from odin_tpu_torch.networks.base import layer_noise, same_padding

__all__ = ["DiscreteDropout", "DropBlock"]


def _noise(rng):
  """`rng` as a ``Noise``: a Noise as it is, a generator wrapped, None the
  step's noise."""
  from odin_tpu_torch.training.core import Noise
  if isinstance(rng, Noise):
    return rng
  if isinstance(rng, torch.Generator):
    return Noise(rng)
  noise = layer_noise()
  if noise is None:
    raise RuntimeError("a dropout layer in training mode draws from a "
                       "generator, a Noise or the step's noise: pass rng= "
                       "or call it through the model's step")
  return noise


class DiscreteDropout(nn.Module):
  """Binomial dropout of counts: a `dropout_rate` share of the entries
  (drawn over `noise_shape`, broadcast to x) are replaced by
  ``Binomial(round(max(x, 0)), 1 - corrupt_rate)``."""

  def __init__(self, dropout_rate: float = 0.3, corrupt_rate: float = 0.2,
               noise_shape: Optional[Sequence[int]] = None):
    super().__init__()
    self.dropout_rate = float(dropout_rate)
    self.corrupt_rate = float(corrupt_rate)
    self.noise_shape = None if noise_shape is None else tuple(
        int(i) for i in noise_shape)

  def build(self, in_shape, generator=None):
    return tuple(in_shape)

  def forward(self, x, rng=None):
    if not self.training or self.dropout_rate <= 0.0:
      return x
    noise = _noise(rng)
    shape = self.noise_shape or tuple(x.shape)
    u = noise.uniform(shape, torch.float32, x.device)
    drop = torch.broadcast_to(u < self.dropout_rate, x.shape).to(x.dtype)
    counts = torch.clamp(torch.round(x.to(torch.float32)), min=0.0)
    keep = torch.full_like(counts, 1.0 - self.corrupt_rate)
    corrupted = noise.draw(
        tuple(x.shape), torch.float32, x.device,
        lambda g: torch.binomial(counts, keep, generator=g)).to(x.dtype)
    return x * (1.0 - drop) + corrupted * drop


class DropBlock(nn.Module):
  """DropBlock (Ghiasi et al. 2018) on NHWC maps: seeds drawn at rate
  ``gamma`` where a whole block fits, dilated into ``blocksize`` squares
  (XLA's SAME max-pool, one row and column more at the end for an even
  block), and the kept activations rescaled by the realised keep
  fraction."""

  def __init__(self, rate: float = 0.1, blocksize: int = 3):
    super().__init__()
    self.rate = float(rate)
    self.blocksize = int(blocksize)

  def build(self, in_shape, generator=None):
    return tuple(in_shape)

  def block_size(self, height: int, width: int) -> int:
    return min(self.blocksize, width, height)

  def gamma(self, height: int, width: int) -> float:
    """The seed rate that drops `rate` of the map once the seeds are
    dilated into blocks."""
    size = self.block_size(height, width)
    return (self.rate * width * height / size ** 2 /
            ((width - size + 1) * (height - size + 1)))

  def forward(self, x, rng=None):
    if not self.training or self.rate <= 0.0:
      return x
    if x.ndim != 4:
      raise ValueError("DropBlock expects NHWC inputs")
    _, height, width, _ = x.shape
    size = self.block_size(height, width)
    u = _noise(rng).uniform(tuple(x.shape), torch.float32, x.device)
    h = torch.arange(height, device=x.device)[:, None]
    w = torch.arange(width, device=x.device)[None, :]
    valid = ((h >= size // 2) & (h < height - (size - 1) // 2) &
             (w >= size // 2) & (w < width - (size - 1) // 2))
    seeds = (u < self.gamma(height, width)) & valid[None, :, :, None]
    lo, hi = same_padding(1, size, 1)  # the window's SAME split, any size
    s = F.pad(seeds.to(x.dtype).permute(0, 3, 1, 2), (lo, hi, lo, hi))
    block = F.max_pool2d(s, size, stride=1).permute(0, 2, 3, 1)
    keep = 1.0 - block
    return x * keep / torch.clamp(torch.mean(keep), min=1e-6)
