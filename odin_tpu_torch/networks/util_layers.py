"""The utility layers of the port (PyTorch port of
``odin_tpu/networks/util_layers.py``: ``Identity`` :31, ``ExpandDims`` :37,
``Reduce`` :44, ``Conv1DTranspose`` :52, ``BatchRenormalization`` :67,
``ParallelNetwork`` :100, ``PositionalEncoder`` :114, ``SkipConnection``
:129, ``ConditionalEmbedding`` :145, ``ConditionalProjection`` :162,
``LSTM`` :188, ``GRU`` :206, ``SimpleRNN`` :220, ``DepthToSpace`` :237 and
``Resampling2D`` :255).

Layouts and parameters are flax's (``weights.from_jax_params``):

  * ``Conv1DTranspose`` holds flax's ``ConvTranspose_0``: its (k, in, out)
    kernel unflipped in flax, here (in, out, k) flipped, with the padding
    and crop of ``base.ConvTranspose``;
  * ``BatchRenormalization`` holds ``gamma`` and ``beta`` itself and its
    running ``mean`` and biased ``var`` in buffers (flax's
    ``batch_stats``), updated through ``record_update`` in training mode;
  * the recurrent layers hold a ``cell``: flax's ``OptimizedLSTMCell``
    (input kernels ``ii/if/ig/io`` without bias, hidden ``hi/hf/hg/ho``
    with) is ``weight_ih`` = [ii; if; ig; io], ``weight_hh`` = [hi; hf;
    hg; ho] and ``bias_hh``, the gate order of ``torch.lstm``; the GRU's
    is ``base.GRUCell``; flax's ``SimpleCell`` (``i`` with bias, ``h``
    without) is ``weight_ih``, ``weight_hh`` and ``bias_ih``.  Each runs
    as one ``torch.lstm``/``torch.gru``/``torch.rnn_tanh`` call from a zero
    carry (cuDNN's RNNs on the card);
  * ``ConditionalEmbedding``'s table is flax's ``embedding/embedding``.

``DepthToSpace`` keeps JAX's NHWC order (r, r, C/r²), which is not
``pixel_shuffle``'s channel order.  ``Resampling2D`` is
``jax.image.resize``: 'nearest' samples at half-pixel centres, the other
methods (linear, cubic with Keys' a = -0.5, lanczos3/5) apply per-axis
weight matrices built as JAX's ``scale_and_translate`` builds them
(antialiased when shrinking), as two products.
"""
from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from odin_tpu_torch.networks.base import (ConvTranspose, Dense, GRUCell,
                                          _new_param, _variance_scaling_,
                                          conv_transpose_padding,
                                          get_activation, record_update)
from odin_tpu_torch.networks.conditional_embedding import _Table

__all__ = ["Identity", "ExpandDims", "Reduce", "Conv1DTranspose",
           "BatchRenormalization", "ParallelNetwork", "PositionalEncoder",
           "SkipConnection", "ConditionalEmbedding", "ConditionalProjection",
           "LSTM", "GRU", "SimpleRNN", "DepthToSpace", "Resampling2D",
           "LSTMCell", "SimpleCell"]

Shape = Tuple[Optional[int], ...]


class Identity(nn.Module):

  def build(self, in_shape: Shape, generator=None) -> Shape:
    return tuple(in_shape)

  def forward(self, x):
    return x


class ExpandDims(nn.Module):

  def __init__(self, axis: int = -1):
    super().__init__()
    self.axis = int(axis)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    # the axis counts the batch dim, which in_shape leaves out
    shape = [None] + list(in_shape)
    shape.insert(self.axis if self.axis >= 0 else self.axis + len(shape) + 1,
                 1)
    return tuple(shape[1:])

  def forward(self, x):
    return torch.unsqueeze(x, self.axis)


_REDUCTIONS = {
    "mean": torch.mean, "sum": torch.sum, "prod": torch.prod,
    "max": torch.amax, "min": torch.amin,
    "std": lambda x, dim: torch.std(x, dim=dim, correction=0),
    "var": lambda x, dim: torch.var(x, dim=dim, correction=0),
    "median": lambda x, dim: torch.quantile(x, 0.5, dim=dim),
    "any": torch.any, "all": torch.all,
    "argmax": torch.argmax, "argmin": torch.argmin,
}


class Reduce(nn.Module):
  """``jnp.<op>(x, axis)`` for `op` among mean, sum, prod, max, min, std
  and var (biased, as numpy's), median, any, all, argmax and argmin."""

  def __init__(self, op: str = "mean", axis: int = 1):
    super().__init__()
    if op not in _REDUCTIONS:
      raise ValueError(f"unknown reduction {op!r}; available: "
                       f"{sorted(_REDUCTIONS)}")
    self.op, self.axis = str(op), int(axis)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    shape = list(in_shape)
    del shape[self.axis if self.axis < 0 else self.axis - 1]
    return tuple(shape)

  def forward(self, x):
    return _REDUCTIONS[self.op](x, dim=self.axis)


class Conv1DTranspose(nn.Module):
  """flax's 1-D ``ConvTranspose`` (unflipped kernel, XLA's padding) on (B,
  T, F), then the activation."""

  bare = False
  flax_kind = ConvTranspose

  def __init__(self, filters: int, kernel_size: int = 3, strides: int = 1,
               activation=None, padding: str = "SAME"):
    super().__init__()
    self.filters = int(filters)
    self.kernel_size = int(kernel_size)
    self.strides = int(strides)
    self.activation = activation
    self.padding = str(padding).upper()
    lo, hi = conv_transpose_padding(self.kernel_size, self.strides,
                                    self.padding)
    self._torch_padding = self.kernel_size - 1 - lo
    self._output_padding = max(hi - lo, 0)
    self._crop = max(lo - hi, 0)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    t, c = in_shape[-2], int(in_shape[-1])
    k = self.kernel_size
    self.weight = _new_param((c, self.filters, k))
    _variance_scaling_(self.weight, 1.0, c * k, generator)  # lecun_normal
    self.bias = nn.Parameter(torch.zeros(self.filters))
    if t is not None:
      t = ((t - 1) * self.strides - 2 * self._torch_padding + k +
           self._output_padding - self._crop)
    return (t, self.filters)

  def forward(self, x):
    y = F.conv_transpose1d(x.transpose(1, 2), self.weight, self.bias,
                           self.strides, self._torch_padding,
                           self._output_padding)
    if self._crop:
      y = y[:, :, :y.shape[2] - self._crop]
    return get_activation(self.activation)(y.transpose(1, 2))


class BatchRenormalization(nn.Module):
  """Batch renormalization (Ioffe 2017) over the last axis: in training
  mode ``(x - mean) / sigma · r + d`` with the batch's mean and biased
  variance, r and d (clipped to `rmax`, `dmax`) held constant for the
  gradient, and the moved running averages handed to ``record_update``;
  in eval mode the running statistics."""

  collection = "batch_stats"

  def __init__(self, momentum: float = 0.99, epsilon: float = 1e-3,
               rmax: float = 3.0, dmax: float = 5.0):
    super().__init__()
    self.momentum, self.epsilon = float(momentum), float(epsilon)
    self.rmax, self.dmax = float(rmax), float(dmax)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    c = int(in_shape[-1])
    self.gamma = nn.Parameter(torch.ones(c))
    self.beta = nn.Parameter(torch.zeros(c))
    self.register_buffer("mean", torch.zeros(c))
    self.register_buffer("var", torch.ones(c))
    return tuple(in_shape)

  def forward(self, x):
    if self.training:
      axes = tuple(range(x.ndim - 1))
      mean = torch.mean(x, dim=axes)
      var = torch.mean(torch.square(x - mean), dim=axes)
      sigma = torch.sqrt(var + self.epsilon)
      ra_sigma = torch.sqrt(self.var + self.epsilon)
      r = torch.clamp(sigma / ra_sigma, 1.0 / self.rmax, self.rmax).detach()
      d = torch.clamp((mean - self.mean) / ra_sigma, -self.dmax,
                      self.dmax).detach()
      xhat = (x - mean) / sigma * r + d
      m = self.momentum
      record_update(self, "mean", m * self.mean + (1 - m) * mean)
      record_update(self, "var", m * self.var + (1 - m) * var)
    else:
      xhat = (x - self.mean) / torch.sqrt(self.var + self.epsilon)
    return self.gamma * xhat + self.beta


class ParallelNetwork(nn.Module):
  """Each layer on the same input, the outputs concatenated on `axis`."""

  def __init__(self, layers: Sequence[nn.Module] = (), axis: int = -1):
    super().__init__()
    self.layers = nn.ModuleList(layers)
    self.axis = int(axis)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    shapes = [layer.build(tuple(in_shape), generator) for layer in self.layers]
    axis = self.axis if self.axis < 0 else self.axis - 1
    out = list(shapes[0])
    out[axis] = sum(int(s[axis]) for s in shapes)
    return tuple(out)

  def forward(self, x):
    return torch.cat([layer(x) for layer in self.layers], dim=self.axis)


class PositionalEncoder(nn.Module):
  """``x`` plus the sinusoidal encoding of its last two axes (T, D), made
  in numpy float64 and cast to float32, as the JAX package makes it."""

  def __init__(self, max_len: int = 10000):
    super().__init__()
    self.max_len = int(max_len)
    self._cache = {}

  def build(self, in_shape: Shape, generator=None) -> Shape:
    return tuple(in_shape)

  def encoding(self, t: int, d: int, device) -> torch.Tensor:
    key = (t, d, str(device))
    if key not in self._cache:
      pos = np.arange(t)[:, None]
      i = np.arange(d)[None, :]
      angle = pos / np.power(self.max_len, (2 * (i // 2)) / d)
      pe = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
      self._cache[key] = torch.from_numpy(pe.astype("float32")).to(device)
    return self._cache[key]

  def forward(self, x):
    return x + self.encoding(x.shape[-2], x.shape[-1], x.device)


class SkipConnection(nn.Module):
  """``layer(x)`` merged with x: 'concat' on the last axis, or 'add', x
  projected by the ``skip_proj`` Dense where the widths differ."""

  def __init__(self, layer: nn.Module, merge: str = "add"):
    super().__init__()
    self.layer = layer
    self.merge = str(merge)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    y = tuple(self.layer.build(tuple(in_shape), generator))
    if self.merge == "concat":
      return y[:-1] + (int(y[-1]) + int(in_shape[-1]),)
    if int(in_shape[-1]) != int(y[-1]):
      self.skip_proj = Dense(int(y[-1]), bare=True)
      self.skip_proj.build(tuple(in_shape), generator)
    return y

  def forward(self, x):
    y = self.layer(x)
    if self.merge == "concat":
      return torch.cat([y, x], dim=-1)
    if hasattr(self, "skip_proj"):
      x = self.skip_proj(x)
    return y + x


class ConditionalEmbedding(nn.Module):
  """Labels to `features`: integer labels through the ``embedding`` table,
  one-hot or soft labels (last axis `num_classes`) as their product with
  it."""

  def __init__(self, num_classes: int, features: int = 32):
    super().__init__()
    self.num_classes, self.features = int(num_classes), int(features)
    self.embedding = _Table(self.num_classes, self.features)

  def build(self, in_shape: Shape = (), generator=None) -> Shape:
    self.embedding.build(generator)
    in_shape = tuple(in_shape or ())
    if in_shape and in_shape[-1] == self.num_classes:
      return in_shape[:-1] + (self.features,)
    return in_shape + (self.features,)

  def forward(self, y):
    if y.ndim >= 2 and y.shape[-1] == self.num_classes:
      return y @ self.embedding.embedding
    return self.embedding(y.to(torch.int64))


class ConditionalProjection(nn.Module):
  """Labels `y` (B, L) projected by ``cond_proj`` to `features` and merged
  into `x` (B, ..., F): 'concat' on the last axis, 'film' as ``x · (1 +
  film_scale(y)) + film_shift(y)``, or 'add' (x projected by ``x_proj``
  where F is not `features`)."""

  def __init__(self, features: int, method: str = "add"):
    super().__init__()
    self.features = int(features)
    self.method = str(method)

  def build(self, x_shape: Shape, generator=None,
            y_shape: Shape = None) -> Shape:
    if y_shape is None:
      raise ValueError("ConditionalProjection.build needs y_shape")
    fx, fy = int(x_shape[-1]), int(y_shape[-1])
    self.cond_proj = Dense(self.features, bare=True)
    self.cond_proj.build((fy,), generator)
    if self.method == "concat":
      return tuple(x_shape[:-1]) + (fx + self.features,)
    if self.method == "film":
      self.film_scale = Dense(fx, bare=True)
      self.film_scale.build((fy,), generator)
      self.film_shift = Dense(fx, bare=True)
      self.film_shift.build((fy,), generator)
      return tuple(x_shape)
    if fx != self.features:
      self.x_proj = Dense(self.features, bare=True)
      self.x_proj.build((fx,), generator)
    return tuple(x_shape[:-1]) + (self.features,)

  def forward(self, x, y):
    def expand(v):
      while v.ndim < x.ndim:
        v = v[:, None]
      return v

    h = expand(self.cond_proj(y))
    if self.method == "concat":
      return torch.cat([x, h.expand(x.shape[:-1] + (self.features,))], -1)
    if self.method == "film":
      scale = expand(self.film_scale(y))
      shift = expand(self.film_shift(y))
      return x * (1 + scale) + shift
    if hasattr(self, "x_proj"):
      x = self.x_proj(x)
    return x + h


def _recurrent_init(module: nn.Module, gates: int, features: int,
                    fan_in: int, generator) -> None:
  """flax's cell initialisers: lecun_normal input kernels and orthogonal
  recurrent ones, a gate at a time."""
  h = features
  module.weight_ih = _new_param((gates * h, fan_in))
  module.weight_hh = _new_param((gates * h, h))
  with torch.no_grad():
    for g in range(gates):
      _variance_scaling_(module.weight_ih[g * h:(g + 1) * h], 1.0, fan_in,
                         generator)
      nn.init.orthogonal_(module.weight_hh[g * h:(g + 1) * h],
                          generator=generator)


class LSTMCell(nn.Module):
  """flax's ``OptimizedLSTMCell``: ``weight_ih`` (4h, in), ``weight_hh``
  (4h, h) and ``bias_hh`` (4h), gates i, f, g, o."""

  def __init__(self, features: int):
    super().__init__()
    self.features = int(features)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    _recurrent_init(self, 4, self.features, int(in_shape[-1]), generator)
    self.bias_hh = nn.Parameter(torch.zeros(4 * self.features))
    return (self.features,)

  def weights(self):
    """[w_ih, w_hh, b_ih, b_hh] as ``torch.lstm`` takes them (b_ih 0)."""
    return [self.weight_ih, self.weight_hh,
            torch.zeros_like(self.bias_hh), self.bias_hh]


class SimpleCell(nn.Module):
  """flax's ``SimpleCell`` (tanh): ``weight_ih`` (h, in), ``weight_hh`` (h,
  h) and ``bias_ih`` (h); the recurrent kernel has no bias."""

  def __init__(self, features: int):
    super().__init__()
    self.features = int(features)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    _recurrent_init(self, 1, self.features, int(in_shape[-1]), generator)
    self.bias_ih = nn.Parameter(torch.zeros(self.features))
    return (self.features,)

  def weights(self):
    """[w_ih, w_hh, b_ih, b_hh] as ``torch.rnn_tanh`` takes them (b_hh
    0)."""
    return [self.weight_ih, self.weight_hh, self.bias_ih,
            torch.zeros_like(self.bias_ih)]


class _Recurrent(nn.Module):
  """A cell run over (B, T, F) from a zero carry: (B, T, units), or the
  last step's output (B, units) without `return_sequences`.  The gates'
  weights are separate parameters, as flax's are, so cuDNN packs them at
  each call (the warning it gives for that is silenced)."""

  def __init__(self, units: int, return_sequences: bool = True):
    super().__init__()
    self.units = int(units)
    self.return_sequences = bool(return_sequences)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    self.cell.build((int(in_shape[-1]),), generator)
    return ((in_shape[-2], self.units) if self.return_sequences
            else (self.units,))

  def _run(self, x, h0):
    raise NotImplementedError

  def forward(self, x):
    h0 = torch.zeros((1, x.shape[0], self.units), dtype=x.dtype,
                     device=x.device)
    with warnings.catch_warnings():
      warnings.filterwarnings("ignore", "RNN module weights are not part")
      ys = self._run(x, h0)
    return ys if self.return_sequences else ys[:, -1]


class LSTM(_Recurrent):

  def __init__(self, units: int, return_sequences: bool = True):
    super().__init__(units, return_sequences)
    self.cell = LSTMCell(self.units)

  def _run(self, x, h0):
    return torch.lstm(x, (h0, torch.zeros_like(h0)), self.cell.weights(),
                      True, 1, 0.0, torch.is_grad_enabled(), False, True)[0]


class GRU(_Recurrent):

  def __init__(self, units: int, return_sequences: bool = True):
    super().__init__(units, return_sequences)
    self.cell = GRUCell(self.units)

  def _run(self, x, h0):
    return torch.gru(x, h0, list(self.cell.weights()), True, 1, 0.0,
                     torch.is_grad_enabled(), False, True)[0]


class SimpleRNN(_Recurrent):

  def __init__(self, units: int, return_sequences: bool = True):
    super().__init__(units, return_sequences)
    self.cell = SimpleCell(self.units)

  def _run(self, x, h0):
    return torch.rnn_tanh(x, h0, self.cell.weights(), True, 1, 0.0,
                          torch.is_grad_enabled(), False, True)[0]


class DepthToSpace(nn.Module):
  """(B, H, W, C·r²) -> (B, H·r, W·r, C), channels read as (r, r, C) in
  NHWC order, as the JAX package reads them."""

  def __init__(self, block_size: int = 2):
    super().__init__()
    self.block_size = int(block_size)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    h, w, c = (int(i) for i in in_shape)
    r = self.block_size
    if c % (r * r):
      raise ValueError(f"DepthToSpace: {c} channels are not a multiple of "
                       f"{r * r}")
    return (h * r, w * r, c // (r * r))

  def forward(self, x):
    r = self.block_size
    b, h, w, c = x.shape
    if c % (r * r):
      raise ValueError(f"DepthToSpace: {c} channels are not a multiple of "
                       f"{r * r}")
    x = x.reshape(b, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * r, w * r, c // (r * r))


def _keys_cubic(x):
  out = ((1.5 * x - 2.5) * x) * x + 1.0
  out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
  return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius: float):
  def kernel(x):
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    safe = torch.where(x != 0, math.pi ** 2 * x * x, torch.ones_like(x))
    out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)
  return kernel


_RESIZE_KERNELS = {
    "linear": lambda x: torch.clamp(1 - torch.abs(x), min=0.0),
    "cubic": _keys_cubic, "lanczos3": _lanczos(3.0),
    "lanczos5": _lanczos(5.0)}
_RESIZE_ALIASES = {"bilinear": "linear", "trilinear": "linear",
                   "triangle": "linear", "bicubic": "cubic",
                   "tricubic": "cubic"}


def resize_weights(in_size: int, out_size: int, method: str,
                   device=None) -> torch.Tensor:
  """The (in_size, out_size) float32 matrix of ``jax.image.resize`` along
  one axis (JAX's ``compute_weight_mat`` with scale out/in, translation 0
  and antialiasing)."""
  kernel = _RESIZE_KERNELS[_RESIZE_ALIASES.get(method, method)]
  inv_scale = 1.0 / (out_size / in_size)
  kernel_scale = max(inv_scale, 1.0)
  f32 = torch.float32
  sample = ((torch.arange(out_size, dtype=f32) + 0.5) *
            torch.tensor(inv_scale, dtype=f32)) - 0.5
  x = torch.abs(sample[None, :] - torch.arange(in_size, dtype=f32)[:, None])
  w = kernel(x / torch.tensor(kernel_scale, dtype=f32))
  total = torch.sum(w, dim=0, keepdim=True)
  eps = 1000.0 * float(np.finfo(np.float32).eps)
  w = torch.where(torch.abs(total) > eps,
                  w / torch.where(total != 0, total, torch.ones_like(total)),
                  torch.zeros_like(w))
  inside = (sample >= -0.5) & (sample <= in_size - 0.5)
  w = torch.where(inside[None, :], w, torch.zeros_like(w))
  return w if device is None else w.to(device)


def _nearest_index(in_size: int, out_size: int, device) -> torch.Tensor:
  pos = (torch.arange(out_size, dtype=torch.float32) + 0.5) * in_size / \
      out_size
  return torch.floor(pos).to(torch.int64).to(device)


class Resampling2D(nn.Module):
  """``jax.image.resize`` of (B, H, W, C) to (B, round(H·factor),
  round(W·factor), C) by `method` ('nearest', 'linear'/'bilinear',
  'cubic'/'bicubic', 'lanczos3', 'lanczos5')."""

  def __init__(self, factor: float = 2.0, method: str = "nearest"):
    super().__init__()
    self.factor = float(factor)
    self.method = str(method)
    if self.method != "nearest" and \
        _RESIZE_ALIASES.get(self.method, self.method) not in _RESIZE_KERNELS:
      raise ValueError(f'Unknown resize method "{self.method}"')
    self._weights = {}

  def _out(self, size: int) -> int:
    return int(round(size * self.factor))

  def build(self, in_shape: Shape, generator=None) -> Shape:
    h, w, c = (int(i) for i in in_shape)
    return (self._out(h), self._out(w), c)

  def _matrix(self, n: int, m: int, device) -> torch.Tensor:
    key = (n, m, str(device))
    if key not in self._weights:
      self._weights[key] = resize_weights(n, m, self.method, device)
    return self._weights[key]

  def forward(self, x):
    _, h, w, _ = x.shape
    oh, ow = self._out(h), self._out(w)
    if self.method == "nearest":
      if oh != h:
        x = x[:, _nearest_index(h, oh, x.device)]
      if ow != w:
        x = x[:, :, _nearest_index(w, ow, x.device)]
      return x
    if oh != h:
      x = torch.einsum("bhwc,hH->bHwc", x,
                       self._matrix(h, oh, x.device).to(x.dtype))
    if ow != w:
      x = torch.einsum("bhwc,wW->bhWc", x,
                       self._matrix(w, ow, x.device).to(x.dtype))
    return x
