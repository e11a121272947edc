"""Residual blocks, squeeze-excitation and masked (PixelCNN) convolutions
of the port (PyTorch port of ``odin_tpu/networks/resnets.py``).

Each block keeps the JAX module's parameter tree: its convolutions, dense
layers and batch norms are flax's own unnamed ``nn.Conv``/``nn.Dense``/
``nn.BatchNorm``, so they are ``bare`` layers of the port held under
flax's automatic names (``Conv_0``, ``Conv_1``, ``ConvTranspose_0``,
``Dense_0``, ``BatchNorm_0``, ``SqueezeExcitation_0``, ...), numbered
per type in the order JAX calls them.  Those that only some inputs need
(a projection shortcut where ``channels != filters or strides != 1``)
are made in ``build``, as flax makes them at init.  Tensors are NHWC at
every boundary.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from odin_tpu_torch.networks.base import (BatchNorm, Conv, ConvTranspose,
                                          Dense, Dropout, _new_param,
                                          _variance_scaling_, get_activation)

__all__ = ["SqueezeExcitation", "SigmoidGating", "ResidualBlock",
           "ResidualUpBlock", "ResidualBottleneck", "ResidualInverted",
           "residual_design", "ResidualSequential", "MaskedConv2D",
           "DownSample", "UpSample", "PixelCNNDecoder"]

Shape = Tuple[int, ...]


class _Named(nn.Module):
  """A module whose children are flax's auto-named layers: ``_add(layer)``
  registers `layer` as ``<Type>_<n>``, n counting that type."""

  def _start(self):
    self._counts = {}
    self._order = []

  def _add(self, kind: str, layer: nn.Module, in_shape, generator) -> Shape:
    n = self._counts.get(kind, 0)
    self._counts[kind] = n + 1
    name = f"{kind}_{n}"
    self.add_module(name, layer)
    self._order.append(name)
    return layer.build(tuple(in_shape), generator)


class SigmoidGating(nn.Module):
  """The channels split in half, the first gated by the sigmoid of the
  second (a GLU)."""

  def build(self, in_shape: Shape, generator=None) -> Shape:
    return tuple(in_shape[:-1]) + (in_shape[-1] // 2,)

  def forward(self, x):
    activation, gate_logits = torch.chunk(x, 2, dim=-1)
    return torch.sigmoid(gate_logits) * activation


class SqueezeExcitation(nn.Module):
  """Squeeze-excitation channel gating: the mean over H and W, a ReLU
  Dense to ``max(C // ratio, 1)``, a sigmoid Dense back to C."""

  def __init__(self, ratio: int = 4):
    super().__init__()
    self.ratio = int(ratio)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    c = int(in_shape[-1])
    self.Dense_0 = Dense(max(c // self.ratio, 1), bare=True)
    self.Dense_0.build((c,), generator)
    self.Dense_1 = Dense(c, bare=True)
    self.Dense_1.build((max(c // self.ratio, 1),), generator)
    return tuple(in_shape)

  def forward(self, x):
    s = torch.mean(x, dim=(1, 2))
    s = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(s))))
    return x * s[:, None, None, :]


class ResidualBlock(_Named):
  """conv, [BN], act, conv, [BN], [SE], plus the input (through a 1x1
  projection where the channels or the stride change), then act."""

  def __init__(self, filters: int, kernel_size: int = 3, strides: int = 1,
               activation: str = "relu", use_se: bool = False,
               batchnorm: bool = False):
    super().__init__()
    self.filters = int(filters)
    self.kernel_size = int(kernel_size)
    self.strides = int(strides)
    self.activation = activation
    self.use_se = bool(use_se)
    self.batchnorm = bool(batchnorm)

  def _first(self):
    return ("Conv", Conv(self.filters, self.kernel_size, self.strides,
                         bare=True))

  def _shortcut(self):
    return ("Conv", Conv(self.filters, 1, self.strides, bare=True))

  def build(self, in_shape: Shape, generator=None) -> Shape:
    self._start()
    bn = lambda shape: (self._add("BatchNorm", BatchNorm(bare=True), shape,
                                  generator) if self.batchnorm else shape)
    shape = bn(self._add(*self._first(), in_shape, generator))
    n = len(self._order)
    shape = bn(self._add("Conv", Conv(self.filters, self.kernel_size, 1,
                                      bare=True), shape, generator))
    if self.use_se:
      shape = self._add("SqueezeExcitation", SqueezeExcitation(), shape,
                        generator)
    self._stages = (self._order[:n], self._order[n:])
    self._shortcut_name = None
    if int(in_shape[-1]) != self.filters or self.strides != 1:
      kind, layer = self._shortcut()
      self._add(kind, layer, in_shape, generator)
      self._shortcut_name = self._order[-1]
    return shape

  def forward(self, x):
    act = get_activation(self.activation)
    first, second = self._stages
    h = x
    for name in first:
      h = getattr(self, name)(h)
    h = act(h)
    for name in second:
      h = getattr(self, name)(h)
    if self._shortcut_name is not None:
      x = getattr(self, self._shortcut_name)(x)
    return act(x + h)


class ResidualUpBlock(ResidualBlock):
  """The up-sampling residual block: a transposed conv, [BN], act, conv,
  [BN], [SE], plus the input (through a transposed 1x1 projection where
  the channels or the stride change), then act."""

  def __init__(self, filters: int, kernel_size: int = 3, strides: int = 2,
               activation: str = "relu", use_se: bool = False,
               batchnorm: bool = False):
    super().__init__(filters, kernel_size, strides, activation, use_se,
                     batchnorm)

  def _first(self):
    return ("ConvTranspose", ConvTranspose(self.filters, self.kernel_size,
                                           self.strides, bare=True))

  def _shortcut(self):
    return ("ConvTranspose", ConvTranspose(self.filters, 1, self.strides,
                                           bare=True))


class _ResidualConvBlock(_Named):
  """The body of ``ResidualBottleneck`` / ``ResidualInverted``: a kxk conv
  resizing the channels by the subclass's ratio, [BN], act, a middle kxk
  conv (depthwise for the inverted block), [BN], act, [SE], a 1x1
  projection to `filters_out` (doubled and GLU-gated with
  `sigmoid_gating`), [BN]; the input is added (after dropout in
  training) only where the shape is kept."""

  def __init__(self, filters_out: Optional[int] = None, se_ratio: float = 0.25,
               sigmoid_gating: bool = False, batchnorm: bool = True,
               kernel_size: int = 3, strides: int = 1,
               activation: str = "swish", dropout: float = 0.0):
    super().__init__()
    self.filters_out = filters_out
    self.se_ratio = se_ratio
    self.sigmoid_gating = bool(sigmoid_gating)
    self.batchnorm = bool(batchnorm)
    self.kernel_size = int(kernel_size)
    self.strides = int(strides)
    self.activation = activation
    self.dropout = float(dropout)

  def _channel_ratio(self) -> float:
    raise NotImplementedError

  def _mid_groups(self, filters: int) -> int:
    return 1

  def build(self, in_shape: Shape, generator=None) -> Shape:
    self._start()
    filters_in = int(in_shape[-1])
    filters = max(1, int(filters_in * self._channel_ratio()))
    out = self.filters_out or filters_in
    use_bias = not self.batchnorm
    k = self.kernel_size
    bn = lambda shape: (self._add("BatchNorm", BatchNorm(bare=True), shape,
                                  generator) if self.batchnorm else shape)
    shape = bn(self._add("Conv", Conv(filters, k, self.strides,
                                      use_bias=use_bias, bare=True),
                         in_shape, generator))
    a = len(self._order)
    shape = bn(self._add("Conv", Conv(filters, k, 1, bare=True,
                                      groups=self._mid_groups(filters)),
                         shape, generator))
    b = len(self._order)
    if self.se_ratio:
      shape = self._add("SqueezeExcitation", SqueezeExcitation(
          ratio=max(int(1 / self.se_ratio), 1)), shape, generator)
    shape = bn(self._add("Conv", Conv(out * (2 if self.sigmoid_gating
                                             else 1), 1, 1,
                                      use_bias=use_bias, bare=True),
                         shape, generator))
    # the layers before each activation: conv [BN]; conv [BN]; the rest
    self._stages = (self._order[:a], self._order[a:b], self._order[b:])
    self.skip = out == filters_in and self.strides == 1
    self.drop = Dropout(self.dropout)
    if self.sigmoid_gating:
      shape = shape[:-1] + (shape[-1] // 2,)
    return shape

  def forward(self, x):
    act = get_activation(self.activation)
    h = x
    for i, stage in enumerate(self._stages):
      for name in stage:
        h = getattr(self, name)(h)
      if i < 2:
        h = act(h)
    if self.sigmoid_gating:
      h = SigmoidGating()(h)
    if self.skip:
      return x + self.drop(h)
    return h


class ResidualBottleneck(_ResidualConvBlock):
  """He's bottleneck block: the channels squeezed by `shrink_ratio`
  through two kxk convs, then a 1x1 projection to `filters_out`."""

  def __init__(self, shrink_ratio: float = 0.5, **kwargs):
    super().__init__(**kwargs)
    self.shrink_ratio = float(shrink_ratio)

  def _channel_ratio(self) -> float:
    return self.shrink_ratio


class ResidualInverted(_ResidualConvBlock):
  """The MobileNetV2 / EfficientNet inverted block: the channels expanded
  by `expand_ratio`, a depthwise kxk conv, [SE], a linear 1x1 projection
  to `filters_out`."""

  def __init__(self, expand_ratio: float = 2.0, **kwargs):
    super().__init__(**kwargs)
    self.expand_ratio = float(expand_ratio)

  def _channel_ratio(self) -> float:
    return self.expand_ratio

  def _mid_groups(self, filters: int) -> int:
    return filters


def residual_design(design: str = "bottleneck", ratio: Optional[float] = None,
                    **kwargs):
  """'bottleneck' (`ratio` its shrink_ratio) or 'inverted' (its
  expand_ratio)."""
  if design == "bottleneck":
    if ratio is not None:
      kwargs["shrink_ratio"] = ratio
    return ResidualBottleneck(**kwargs)
  if design == "inverted":
    if ratio is not None:
      kwargs["expand_ratio"] = ratio
    return ResidualInverted(**kwargs)
  raise NotImplementedError(f"no support for residual design: {design!r}")


class ResidualSequential(_Named):
  """A stack of residual blocks; a negative stride selects an up block
  (-2: ``ResidualUpBlock(strides=2)``)."""

  def __init__(self, filters: Sequence[int] = (64, 64), kernel_size: int = 3,
               strides: Optional[Sequence[int]] = None,
               activation: str = "relu", use_se: bool = False):
    super().__init__()
    self.filters = tuple(int(f) for f in filters)
    self.kernel_size = int(kernel_size)
    self.strides = tuple(int(s) for s in (strides or [1] * len(filters)))
    self.activation = activation
    self.use_se = bool(use_se)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    self._start()
    shape = tuple(in_shape)
    for f, s in zip(self.filters, self.strides):
      if s < 0:
        shape = self._add("ResidualUpBlock", ResidualUpBlock(
            f, self.kernel_size, -s, self.activation, self.use_se), shape,
            generator)
      else:
        shape = self._add("ResidualBlock", ResidualBlock(
            f, self.kernel_size, s, self.activation, self.use_se), shape,
            generator)
    return shape

  def forward(self, x):
    for name in self._order:
      x = getattr(self, name)(x)
    return x


def _causal_mask(k: int, mask_type: str) -> np.ndarray:
  """(k, k) mask of a PixelCNN kernel: the rows below the centre and the
  centre row from the centre ('A') or right of it ('B') are 0."""
  mask = np.ones((k, k), np.float32)
  mask[k // 2, k // 2 + (1 if mask_type == "B" else 0):] = 0.0
  mask[k // 2 + 1:] = 0.0
  return mask


class MaskedConv2D(Conv):
  """The PixelCNN masked convolution (SAME, stride 1): mask 'A' hides the
  centre pixel, 'B' keeps it.  Holds its own ``kernel`` and ``bias``, as
  the JAX module does."""

  def __init__(self, filters: int, kernel_size: int = 3, mask_type: str = "A"):
    super().__init__(filters, kernel_size, 1, None, "SAME", True, bare=True)
    self.mask_type = mask_type
    self.register_buffer("mask", torch.from_numpy(
        _causal_mask(int(kernel_size), mask_type)), persistent=False)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    c = int(in_shape[-1])
    k = self.kernel_size[0]
    self.weight = _new_param((self.filters, c, k, k))
    _variance_scaling_(self.weight, 2.0, c * k * k, generator)  # he_normal
    self.bias = nn.Parameter(torch.zeros(self.filters))
    return tuple(in_shape[:-1]) + (self.filters,)

  def _kernel(self):
    return self.weight * self.mask.to(self.weight.dtype)


class DownSample(Conv):
  """A strided-conv down-sampling block: kernel 2·factor, stride factor,
  SAME (flax's ``nn.Conv`` under ``Conv_0``, LeCun init)."""

  he_init = False

  def __init__(self, filters: int, factor: int = 2, activation: str = "relu"):
    super().__init__(filters, 2 * int(factor), int(factor), activation)
    self.factor = int(factor)


class UpSample(ConvTranspose):
  """A transposed-conv up-sampling block: kernel 2·factor, stride factor,
  SAME (flax's ``nn.ConvTranspose`` under ``ConvTranspose_0``, LeCun
  init)."""

  he_init = False

  def __init__(self, filters: int, factor: int = 2, activation: str = "relu"):
    super().__init__(filters, 2 * int(factor), int(factor), activation)
    self.factor = int(factor)


class PixelCNNDecoder(_Named):
  """A small PixelCNN decoder: the latent through a tanh Dense
  (``decoder0``) to an H x W x C map, a 7x7 type-A masked conv, then
  `n_layers` ReLU + 3x3 type-B masked convs, a ReLU and a 1x1 conv to
  ``C · n_params`` channels (NHWC out)."""

  def __init__(self, output_shape: Sequence[int] = (32, 32, 3),
               n_filters: int = 32, n_layers: int = 4, n_params: int = 2):
    super().__init__()
    self.output_shape = tuple(int(i) for i in output_shape)
    self.n_filters = int(n_filters)
    self.n_layers = int(n_layers)
    self.n_params = int(n_params)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    self._start()
    h, w, c = self.output_shape
    self.decoder0 = Dense(h * w * c, bare=True)
    self.decoder0.build(tuple(in_shape), generator)
    shape = self._add("MaskedConv2D", MaskedConv2D(self.n_filters, 7, "A"),
                      (h, w, c), generator)
    for _ in range(self.n_layers):
      shape = self._add("MaskedConv2D", MaskedConv2D(self.n_filters, 3, "B"),
                        shape, generator)
    return self._add("Conv", Conv(c * self.n_params, 1, 1, bare=True), shape,
                     generator)

  def forward(self, z):
    h, w, c = self.output_shape
    x = torch.tanh(self.decoder0(z)).reshape(-1, h, w, c)
    for i, name in enumerate(self._order):
      if i > 0:
        x = F.relu(x)
      x = getattr(self, name)(x)
    return x
