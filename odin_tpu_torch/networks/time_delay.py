"""Time-delay (TDNN) layers and the x-vector network of the port (PyTorch
port of ``odin_tpu/networks/time_delay.py``: ``TimeDelay`` :26,
``TimeDelayDense`` :60, ``TimeDelayConv`` :66, ``TimeDelayConvTied`` :81,
``StatsPool`` :103 and ``XVectorNet`` :112).

Inputs are (B, T, F), as in the JAX package; the 1-D convolutions run on
(B, F, T) views inside.  A weight is (out, in, k), flax's (k, in, out)
kernel permuted (``weights.from_jax_params``).  As flax names them:

  * ``TimeDelay`` with an evenly spaced context is one dilated VALID
    convolution (flax's ``Conv_0``); an irregular context gathers the
    frames at the sorted offsets, concatenates them in offset order and
    applies one ``Dense_0``;
  * ``TimeDelayConv`` is a SAME convolution with dilation (``Conv_0``);
    XLA's SAME splits the padding of an even effective width one frame
    more at the end;
  * ``TimeDelayConvTied`` holds one raw ``kernel`` and ``bias`` itself,
    the kernel applied at each dilation and the results summed;
  * ``XVectorNet``'s layers are ``TimeDelayConv_0`` ... ``TimeDelayConv_4``
    and the bare Denses ``embedding_a``, ``embedding_b`` and
    ``classifier``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from odin_tpu_torch.networks.base import (Conv, Dense, _new_param,
                                          _variance_scaling_, get_activation,
                                          same_padding)

__all__ = ["TimeDelay", "TimeDelayDense", "TimeDelayConv",
           "TimeDelayConvTied", "StatsPool", "XVectorNet"]

Shape = Tuple[Optional[int], ...]


def _conv1d(x, weight, bias, dilation: int, padding: str):
  """``x`` (B, T, F) through a stride-1 convolution with XLA's `padding`
  ('SAME' or 'VALID'), back to (B, T', out)."""
  y = x.transpose(1, 2)
  if padding == "SAME":
    lo, hi = same_padding(1, (weight.shape[-1] - 1) * dilation + 1, 1)
    if lo != hi:
      y, lo = F.pad(y, (lo, hi)), 0
    y = F.conv1d(y, weight, bias, dilation=dilation, padding=lo)
  else:
    y = F.conv1d(y, weight, bias, dilation=dilation)
  return y.transpose(1, 2)


class TimeDelay(nn.Module):
  """Dense over a window of frames at `context` offsets: (B, T, F) ->
  (B, T - span + 1, units)."""

  bare = False

  def __init__(self, units: int, context: Sequence[int] = (-2, -1, 0, 1, 2),
               activation="relu", use_bias: bool = True):
    super().__init__()
    ctx = sorted(int(c) for c in context)
    self.units = int(units)
    self.context = tuple(ctx)
    self.offsets = tuple(c - ctx[0] for c in ctx)
    self.span = ctx[-1] - ctx[0] + 1
    self.activation = activation
    self.use_bias = bool(use_bias)
    gaps = {int(g) for g in np.diff(ctx)} if len(ctx) > 1 else {1}
    self.regular = len(gaps) == 1
    self.dilation = gaps.pop() if self.regular and len(ctx) > 1 else 1

  @property
  def flax_kind(self):
    """The flax primitive that holds the parameters (``Conv_0`` or
    ``Dense_0``)."""
    return Conv if self.regular else Dense

  def build(self, in_shape: Shape, generator=None) -> Shape:
    t, f = in_shape[-2], int(in_shape[-1])
    k = len(self.context)
    shape = (self.units, f, k) if self.regular else (self.units, f * k)
    self.weight = _new_param(shape)
    _variance_scaling_(self.weight, 1.0, f * k, generator)  # lecun_normal
    self.bias = (nn.Parameter(torch.zeros(self.units)) if self.use_bias
                 else None)
    return (None if t is None else t - self.span + 1, self.units)

  def forward(self, x):
    if self.regular:
      y = _conv1d(x, self.weight, self.bias, self.dilation, "VALID")
    else:
      valid = x.shape[1] - self.span + 1
      y = F.linear(torch.cat([x[:, o:o + valid] for o in self.offsets], -1),
                   self.weight, self.bias)
    return get_activation(self.activation)(y)


class TimeDelayDense(TimeDelay):
  """Context (0,): a Dense on each frame."""

  def __init__(self, units: int, context: Sequence[int] = (0,),
               activation="relu", use_bias: bool = True):
    super().__init__(units, context, activation, use_bias)


class TimeDelayConv(nn.Module):
  """A SAME convolution over time with dilation: (B, T, F) -> (B, T,
  units)."""

  bare = False
  flax_kind = Conv

  def __init__(self, units: int, kernel_size: int = 5, dilation: int = 1,
               activation="relu"):
    super().__init__()
    self.units = int(units)
    self.kernel_size = int(kernel_size)
    self.dilation = int(dilation)
    self.activation = activation

  def build(self, in_shape: Shape, generator=None) -> Shape:
    f, k = int(in_shape[-1]), self.kernel_size
    self.weight = _new_param((self.units, f, k))
    _variance_scaling_(self.weight, 1.0, f * k, generator)  # flax nn.Conv
    self.bias = nn.Parameter(torch.zeros(self.units))
    return (in_shape[-2], self.units)

  def forward(self, x):
    return get_activation(self.activation)(
        _conv1d(x, self.weight, self.bias, self.dilation, "SAME"))


class TimeDelayConvTied(nn.Module):
  """One kernel applied at each of `dilations` (SAME), the results summed,
  plus one bias: (B, T, F) -> (B, T, units)."""

  bare = True
  flax_kind = Conv

  def __init__(self, units: int, kernel_size: int = 3,
               dilations: Sequence[int] = (1, 2, 3), activation="relu"):
    super().__init__()
    self.units = int(units)
    self.kernel_size = int(kernel_size)
    self.dilations = tuple(int(d) for d in dilations)
    self.activation = activation

  def build(self, in_shape: Shape, generator=None) -> Shape:
    f, k = int(in_shape[-1]), self.kernel_size
    self.weight = _new_param((self.units, f, k))
    _variance_scaling_(self.weight, 2.0, f * k, generator)  # he_normal
    self.bias = nn.Parameter(torch.zeros(self.units))
    return (in_shape[-2], self.units)

  def forward(self, x):
    out = 0.0
    for d in self.dilations:
      out = out + _conv1d(x, self.weight, None, d, "SAME")
    return get_activation(self.activation)(out + self.bias)


class StatsPool(nn.Module):
  """The mean and standard deviation over time, ``sqrt(max(var, 1e-8))``
  of the biased variance: (B, T, F) -> (B, 2F)."""

  def build(self, in_shape: Shape, generator=None) -> Shape:
    return (2 * int(in_shape[-1]),)

  def forward(self, x):
    mean = torch.mean(x, dim=1)
    var = torch.mean(torch.square(x - mean[:, None]), dim=1)
    return torch.cat([mean, torch.sqrt(torch.clamp(var, min=1e-8))], -1)


# (units, kernel size, dilation) of the five frame-level layers
XVECTOR_LAYERS = ((512, 5, 1), (512, 3, 2), (512, 3, 3), (512, 1, 1),
                  (1500, 1, 1))


class XVectorNet(nn.Module):
  """The x-vector network (Snyder et al.): five TDNN layers (512-512-512-
  512-1500), statistics pooling to 3000, ``embedding_a``, then with
  `n_classes` a ReLU, ``embedding_b`` with a ReLU and the ``classifier``'s
  logits.  ``forward(x, return_embedding=True)`` (or ``n_classes=0``)
  returns ``embedding_a``'s output before its ReLU."""

  def __init__(self, n_classes: int = 0, embedding_dim: int = 512):
    super().__init__()
    self.n_classes = int(n_classes)
    self.embedding_dim = int(embedding_dim)
    for i, (units, k, d) in enumerate(XVECTOR_LAYERS):
      self.add_module(f"TimeDelayConv_{i}",
                      TimeDelayConv(units, kernel_size=k, dilation=d))
    self.StatsPool_0 = StatsPool()
    self.embedding_a = Dense(self.embedding_dim, bare=True)
    if self.n_classes:
      self.embedding_b = Dense(self.embedding_dim, bare=True)
      self.classifier = Dense(self.n_classes, bare=True)

  def frame_layers(self):
    return [getattr(self, f"TimeDelayConv_{i}")
            for i in range(len(XVECTOR_LAYERS))]

  def build(self, in_shape: Shape, generator=None) -> Shape:
    """Parameters for inputs of `in_shape` (T, F); T may be None."""
    shape = tuple(in_shape)
    for layer in self.frame_layers():
      shape = layer.build(shape, generator)
    shape = self.embedding_a.build(self.StatsPool_0.build(shape), generator)
    if self.n_classes:
      shape = self.embedding_b.build(shape, generator)
      shape = self.classifier.build(shape, generator)
    return shape

  def forward(self, x, return_embedding: bool = False):
    for layer in self.frame_layers():
      x = layer(x)
    emb = self.embedding_a(self.StatsPool_0(x))
    if return_embedding or not self.n_classes:
      return emb
    h = F.relu(self.embedding_b(F.relu(emb)))
    return self.classifier(h)
