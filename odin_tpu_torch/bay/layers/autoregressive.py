"""Masked autoregressive dense network, the MADE projection of a
``DistributionDense(autoregressive=True)`` head (PyTorch port of
``odin_tpu/bay/layers/autoregressive.py``: ``_degrees`` :31, the masks
:39-78).

The parameters of event dimension i depend only on input units whose
degree is below i + 1: inputs take degrees cyclically 1..E, hidden units
1..E-1 (MADE's degrees generalised to any width).  The output layout is
parameter-major, ``[p0(dim0..dimE), p1(dim0..dimE), ...]``, what the
distribution builders read.  The masks are constants made from the
degrees at construction (non-persistent buffers); the kernels keep flax's
(in, out) layout and names (``kernel_<i>``, ``bias_<i>``, ``kernel_out``,
``bias_out``).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from odin_tpu_torch.networks.base import get_activation

__all__ = ["AutoregressiveDense"]


def _degrees(n: int, event_size: int, is_input: bool) -> np.ndarray:
  """MADE degrees: inputs cycle 1..event_size; hidden units cycle
  1..event_size-1 (so every hidden unit can feed at least one output)."""
  if is_input or event_size <= 1:
    return (np.arange(n) % max(event_size, 1)) + 1
  return (np.arange(n) % max(event_size - 1, 1)) + 1


def made_masks(n_in: int, event_size: int, hidden_units: Sequence[int],
               params: int):
  """The 0/1 masks (float32, (in, out)) of each hidden layer, then of the
  output layer (the event mask tiled `params` times, parameter-major)."""
  masks = []
  deg_prev = _degrees(n_in, event_size, is_input=True)
  for width in hidden_units:
    deg = _degrees(int(width), event_size, is_input=False)
    masks.append((deg_prev[:, None] <= deg[None, :]).astype(np.float32))
    deg_prev = deg
  deg_out = np.arange(1, event_size + 1)
  out = (deg_prev[:, None] < deg_out[None, :]).astype(np.float32)
  masks.append(np.tile(out, (1, params)))
  return masks


def _glorot_normal_(w: torch.Tensor, generator) -> torch.Tensor:
  """flax's ``glorot_normal``: a truncated normal of variance 2 / (fan_in
  + fan_out), `w` in the (in, out) layout."""
  std = math.sqrt(2.0 / (w.shape[0] + w.shape[1])) / .87962566103423978
  with torch.no_grad():
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class AutoregressiveDense(nn.Module):
  """``y[..., i*params:]``'s event dim j depends only on inputs of degree
  below j + 1."""

  def __init__(self, params: int, event_size: int,
               hidden_units: Sequence[int] = (), use_bias: bool = True,
               activation: str = "relu"):
    super().__init__()
    self.params = int(params)
    self.event_size = int(event_size)
    self.hidden_units = tuple(int(u) for u in hidden_units)
    self.use_bias = bool(use_bias)
    self.activation = activation

  def _names(self):
    return [str(i) for i in range(len(self.hidden_units))] + ["out"]

  def build(self, in_shape, generator=None):
    n_in = int(in_shape[-1])
    widths = self.hidden_units + (self.params * self.event_size,)
    fan_in = n_in
    for name, width, mask in zip(self._names(), widths, made_masks(
        n_in, self.event_size, self.hidden_units, self.params)):
      kernel = nn.Parameter(torch.empty(fan_in, width))
      _glorot_normal_(kernel, generator)
      setattr(self, f"kernel_{name}", kernel)
      setattr(self, f"bias_{name}", nn.Parameter(torch.zeros(width))
              if self.use_bias else None)
      self.register_buffer(f"mask_{name}", torch.from_numpy(mask),
                           persistent=False)
      fan_in = width
    return tuple(in_shape[:-1]) + (widths[-1],)

  def forward(self, x):
    act = get_activation(None if self.activation == "linear"
                         else self.activation)
    h = x
    names = self._names()
    for name in names:
      out = h @ (getattr(self, f"kernel_{name}") *
                 getattr(self, f"mask_{name}"))
      bias = getattr(self, f"bias_{name}")
      if bias is not None:
        out = out + bias
      h = act(out) if name != names[-1] else out
    return h
