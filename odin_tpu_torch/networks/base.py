"""Network layers of the port (PyTorch port of ``odin_tpu/networks/base.py``).

Layers keep the JAX package's NHWC layout at their boundaries; the
convolutions permute to NCHW views inside (the permuted tensor keeps
channels-last strides, so no copy is made).  flax infers input widths when
it initialises; here every layer has ``build(in_shape, generator)``, which
creates its parameters for one example of shape `in_shape` (batch dim
excluded), draws them with flax's initialisers from `generator`, and
returns the output shape.  ``SequentialNetwork.build`` chains them.

State that is not a parameter (flax's mutable collections: BatchNorm's
``batch_stats``, a VQ codebook's EMA statistics) lives in buffers, which
a model carries in ``TrainState.mutables``.  A layer in training mode
never writes its buffers: inside ``collecting_updates()`` it hands their
new values to the dict the context yields (``record_update``), as a flax
``apply(..., mutable=...)`` returns them.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "Dense", "GRUCell", "Conv", "ConvTranspose", "Flatten", "Reshape",
    "CenterAt0",
    "Lambda", "BatchNorm", "SequentialNetwork", "get_activation",
    "same_padding", "conv_transpose_padding", "collecting_updates",
    "record_update", "layer_noise",
]

Shape = Tuple[int, ...]

_ACTIVATIONS: Dict[str, Callable] = {
    "linear": lambda x: x,
    "identity": lambda x: x,
    "relu": F.relu,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "softmax": lambda x: F.softmax(x, dim=-1),
    "leaky_relu": F.leaky_relu,
    "relu6": F.relu6,
    "mish": F.mish,
    "softsign": F.softsign,
    # softplus shifted to pass through 1 at 0 (strictly-positive scale heads)
    "softplus1": lambda x: F.softplus(x + math.log(math.e - 1.0)),
}


def get_activation(fn: Union[str, Callable, None]) -> Callable:
  """Resolve an activation alias."""
  if fn is None:
    return lambda x: x
  if callable(fn):
    return fn
  key = str(fn).lower()
  if key not in _ACTIVATIONS:
    raise ValueError(f"unknown activation '{fn}'; available: {sorted(_ACTIVATIONS)}")
  return _ACTIVATIONS[key]


class _Updates(threading.local):
  updates: Optional[dict] = None
  noise = None


_UPDATES = _Updates()


@contextlib.contextmanager
def collecting_updates(noise=None):
  """Inside, layers in training mode hand the new values of their buffers
  to the yielded dict, keyed by (module, buffer name); `noise` (a
  ``training.core.Noise``) is where such a layer draws from
  (``layer_noise``)."""
  saved = (_UPDATES.updates, _UPDATES.noise)
  _UPDATES.updates, _UPDATES.noise = {}, noise
  try:
    yield _UPDATES.updates
  finally:
    _UPDATES.updates, _UPDATES.noise = saved


def record_update(module: nn.Module, name: str, value: torch.Tensor):
  """The new value of `module`'s buffer `name` (dropped outside
  ``collecting_updates``, as flax drops an update to an immutable
  collection's copy)."""
  if _UPDATES.updates is not None:
    _UPDATES.updates[(module, name)] = value


def layer_noise():
  """The ``Noise`` of the enclosing ``collecting_updates``, or None."""
  return _UPDATES.noise


def _pair(v) -> Tuple[int, int]:
  return tuple(int(i) for i in v) if isinstance(v, (tuple, list)) \
      else (int(v), int(v))


def _variance_scaling_(w: torch.Tensor, scale: float, fan_in: int,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
  """flax's ``variance_scaling(scale, 'fan_in', 'truncated_normal')``."""
  std = math.sqrt(scale / fan_in) / .87962566103423978
  with torch.no_grad():
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def _new_param(shape: Shape) -> nn.Parameter:
  return nn.Parameter(torch.empty(shape, dtype=torch.float32))


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
  """(low, high) padding of XLA's 'SAME' for one spatial dim."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


def conv_transpose_padding(kernel: int, stride: int,
                           padding: str) -> Tuple[int, int]:
  """(low, high) padding of the stride-dilated input in
  ``lax.conv_transpose`` (what flax's ``ConvTranspose`` calls)."""
  if padding == "SAME":
    pad_len = kernel + stride - 2
    pad_a = kernel - 1 if stride > kernel - 1 else int(math.ceil(pad_len / 2))
  elif padding == "VALID":
    pad_len = kernel + stride - 2 + max(kernel - stride, 0)
    pad_a = kernel - 1
  else:
    raise ValueError(f"unsupported padding {padding!r}")
  return pad_a, pad_len - pad_a


class Dense(nn.Module):
  """``y = act(x W^T + b)``; ``weight`` is (out, in), flax's kernel
  transposed.  ``bare`` marks a Dense that stands for one of flax's own
  ``nn.Dense`` layers (its flax path holds the kernel itself) and not for
  the package's ``Dense`` layer (which holds it under ``Dense_0``)."""

  def __init__(self, units: int, activation=None, use_bias: bool = True,
               bare: bool = False):
    super().__init__()
    self.units = int(units)
    self.activation = activation
    self.use_bias = bool(use_bias)
    self.bare = bool(bare)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    fan_in = int(in_shape[-1])
    self.weight = _new_param((self.units, fan_in))
    _variance_scaling_(self.weight, 1.0, fan_in, generator)  # lecun_normal
    self.bias = nn.Parameter(torch.zeros(self.units)) if self.use_bias else None
    return tuple(in_shape[:-1]) + (self.units,)

  def forward(self, x):
    return get_activation(self.activation)(F.linear(x, self.weight, self.bias))


class GRUCell(nn.Module):
  """flax's ``nn.GRUCell`` (r, z, n gates; ``ir``/``iz``/``in`` with bias,
  ``hr``/``hz`` without, ``hn`` with) as ``torch.gru_cell``, whose
  formula is the same: ``weight_ih`` is ``[ir; iz; in]`` and ``weight_hh``
  ``[hr; hz; hn]`` (each flax kernel transposed), ``bias_ih`` is
  ``[b_ir; b_iz; b_in]``, and ``bias_hn`` is ``hn``'s bias alone (the
  hidden bias of the r and z gates is 0 and no parameter, as in flax).
  ``forward(h, x) -> h'``, the carry first as in flax; a loop over time
  takes ``weights()`` once and passes them to each step."""

  def __init__(self, features: int):
    super().__init__()
    self.features = int(features)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    h, fan_in = self.features, int(in_shape[-1])
    self.weight_ih = _new_param((3 * h, fan_in))
    self.weight_hh = _new_param((3 * h, h))
    with torch.no_grad():
      for g in range(3):  # flax: lecun_normal inputs, orthogonal recurrence
        _variance_scaling_(self.weight_ih[g * h:(g + 1) * h], 1.0, fan_in,
                           generator)
        nn.init.orthogonal_(self.weight_hh[g * h:(g + 1) * h],
                            generator=generator)
    self.bias_ih = nn.Parameter(torch.zeros(3 * h))
    self.bias_hn = nn.Parameter(torch.zeros(h))
    return (h,)

  def weights(self):
    """(weight_ih, weight_hh, bias_ih, bias_hh) as ``torch.gru_cell``
    takes them."""
    zeros = torch.zeros(2 * self.features, dtype=self.bias_hn.dtype,
                        device=self.bias_hn.device)
    return (self.weight_ih, self.weight_hh, self.bias_ih,
            torch.cat([zeros, self.bias_hn]))

  def forward(self, h, x, weights=None):
    return torch.gru_cell(x, h, *(weights or self.weights()))


class Conv(nn.Module):
  """2-D convolution on NHWC tensors, XLA padding, He init; ``weight`` is
  (out, in, kh, kw), flax's HWIO kernel permuted.  ``bare`` marks a Conv
  that stands for one of flax's own ``nn.Conv`` layers (a ladder rung's
  convolutions, a U-Net skip's projection): its flax path holds the kernel
  itself, and it draws its kernel with flax's default LeCun init."""

  def __init__(self, filters: int, kernel_size=3, strides=1, activation=None,
               padding: str = "SAME", use_bias: bool = True,
               bare: bool = False):
    super().__init__()
    self.filters = int(filters)
    self.kernel_size = _pair(kernel_size)
    self.strides = _pair(strides)
    self.activation = activation
    self.padding = str(padding).upper()
    self.use_bias = bool(use_bias)
    self.bare = bool(bare)

  def _pads(self, h: int, w: int):
    if self.padding == "VALID":
      return (0, 0), (0, 0)
    if self.padding != "SAME":
      raise ValueError(f"unsupported padding {self.padding!r}")
    (kh, kw), (sh, sw) = self.kernel_size, self.strides
    return same_padding(h, kh, sh), same_padding(w, kw, sw)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    h, w, c = (int(i) for i in in_shape)
    kh, kw = self.kernel_size
    self.weight = _new_param((self.filters, c, kh, kw))
    # he_normal, or flax's lecun_normal for a bare nn.Conv
    _variance_scaling_(self.weight, 1.0 if self.bare else 2.0, c * kh * kw,
                       generator)
    self.bias = nn.Parameter(torch.zeros(self.filters)) if self.use_bias else None
    (ph, qh), (pw, qw) = self._pads(h, w)
    sh, sw = self.strides
    return ((h + ph + qh - kh) // sh + 1, (w + pw + qw - kw) // sw + 1,
            self.filters)

  def forward(self, x):
    (ph, qh), (pw, qw) = self._pads(x.shape[1], x.shape[2])
    y = x.permute(0, 3, 1, 2)
    if ph == qh and pw == qw:
      y = F.conv2d(y, self.weight, self.bias, self.strides, (ph, pw))
    else:
      y = F.conv2d(F.pad(y, (pw, qw, ph, qh)), self.weight, self.bias,
                   self.strides)
    return get_activation(self.activation)(y.permute(0, 2, 3, 1))


class ConvTranspose(nn.Module):
  """2-D transposed convolution on NHWC tensors with flax's semantics.

  flax runs ``lax.conv_transpose`` with an unflipped (kh, kw, in, out)
  kernel: a correlation of the stride-dilated input, padded per
  ``conv_transpose_padding``.  ``F.conv_transpose2d`` correlates the same
  dilated input with the spatially flipped (in, out, kh, kw) weight, padded
  by ``kh - 1 - padding`` on both sides plus ``output_padding`` at the end.
  So ``weight`` holds flax's kernel flipped and permuted, and the padding
  is matched by ``padding = k - 1 - low`` and an output padding, or a crop
  where XLA pads the end less than the start.  ``bare`` as for ``Conv``
  (a ladder rung's ``merge_deconv``).
  """

  def __init__(self, filters: int, kernel_size=3, strides=1, activation=None,
               padding: str = "SAME", use_bias: bool = True,
               bare: bool = False):
    super().__init__()
    self.filters = int(filters)
    self.kernel_size = _pair(kernel_size)
    self.strides = _pair(strides)
    self.activation = activation
    self.padding = str(padding).upper()
    self.use_bias = bool(use_bias)
    self.bare = bool(bare)
    pads = [conv_transpose_padding(k, s, self.padding)
            for k, s in zip(self.kernel_size, self.strides)]
    self._torch_padding = tuple(k - 1 - lo for k, (lo, _) in
                                zip(self.kernel_size, pads))
    self._output_padding = tuple(max(hi - lo, 0) for lo, hi in pads)
    self._crop = tuple(max(lo - hi, 0) for lo, hi in pads)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    h, w, c = (int(i) for i in in_shape)
    kh, kw = self.kernel_size
    self.weight = _new_param((c, self.filters, kh, kw))
    _variance_scaling_(self.weight, 1.0 if self.bare else 2.0, c * kh * kw,
                       generator)
    self.bias = nn.Parameter(torch.zeros(self.filters)) if self.use_bias else None
    out = []
    for size, k, s, p, op, crop in zip((h, w), self.kernel_size, self.strides,
                                       self._torch_padding,
                                       self._output_padding, self._crop):
      out.append((size - 1) * s - 2 * p + k + op - crop)
    return tuple(out) + (self.filters,)

  def forward(self, x):
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                           self.strides, self._torch_padding,
                           self._output_padding)
    ch, cw = self._crop
    if ch or cw:
      y = y[:, :, :y.shape[2] - ch, :y.shape[3] - cw]
    return get_activation(self.activation)(y.permute(0, 2, 3, 1))


class Flatten(nn.Module):
  """(B, ...) -> (B, prod(...)) in the tensor's own (NHWC) order."""

  def build(self, in_shape: Shape, generator=None) -> Shape:
    return (int(np.prod(in_shape)),)

  def forward(self, x):
    return x.reshape(x.shape[0], -1) if x.ndim > 1 else x


class Reshape(nn.Module):

  def __init__(self, shape: Sequence[int]):
    super().__init__()
    self.shape = tuple(int(i) for i in shape)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    return self.shape

  def forward(self, x):
    return x.reshape((x.shape[0],) + self.shape)


class CenterAt0(nn.Module):
  """[0, 1] images -> [-1, 1]."""

  def __init__(self, enable: bool = True, div_255: bool = False):
    super().__init__()
    self.enable = bool(enable)
    self.div_255 = bool(div_255)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    return tuple(in_shape)

  def forward(self, x):
    if not self.enable:
      return x
    if self.div_255:
      x = x / 255.0
    return 2.0 * x - 1.0


class Lambda(nn.Module):
  """A function of the input as a layer (it holds no parameters)."""

  def __init__(self, fn: Callable):
    super().__init__()
    self.fn = fn

  def build(self, in_shape: Shape, generator=None) -> Shape:
    return tuple(self.fn(torch.zeros((1,) + tuple(in_shape))).shape[1:])

  def forward(self, x):
    return self.fn(x)


class BatchNorm(nn.Module):
  """flax's ``BatchNorm`` over the last axis (momentum 0.99, epsilon
  1e-5): params ``scale`` and ``bias``; running ``mean`` and ``var`` in
  buffers, flax's ``batch_stats`` collection.  In training mode it
  normalises by the batch's statistics (the variance as ``E[x^2] -
  E[x]^2``, clipped at 0, flax's fast variance) and hands the moved
  running averages to ``record_update``; in eval mode it uses the running
  ones."""

  collection = "batch_stats"

  def __init__(self, momentum: float = 0.99, epsilon: float = 1e-5):
    super().__init__()
    self.momentum = float(momentum)
    self.epsilon = float(epsilon)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    c = int(in_shape[-1])
    self.scale = nn.Parameter(torch.ones(c))
    self.bias = nn.Parameter(torch.zeros(c))
    self.register_buffer("mean", torch.zeros(c))
    self.register_buffer("var", torch.ones(c))
    return tuple(in_shape)

  def forward(self, x):
    if self.training:
      axes = tuple(range(x.ndim - 1))
      mean = torch.mean(x, dim=axes)
      var = torch.clamp(torch.mean(x * x, dim=axes) - mean * mean, min=0.0)
      m = self.momentum
      record_update(self, "mean", m * self.mean + (1 - m) * mean)
      record_update(self, "var", m * self.var + (1 - m) * var)
    else:
      mean, var = self.mean, self.var
    mul = torch.rsqrt(var + self.epsilon) * self.scale
    return (x - mean) * mul + self.bias


class SequentialNetwork(nn.Module):
  """Call layers in order; ``layers.<i>`` matches flax's ``layers_<i>``.
  ``forward(x, return_hidden=True)`` also returns every layer's output, in
  order (index 0 is the first layer's: ``CenterAt0``'s in an image
  encoder), which a ladder rung's spec counts by."""

  def __init__(self, layers: Sequence[nn.Module] = ()):
    super().__init__()
    self.layers = nn.ModuleList(layers)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    shape = tuple(in_shape)
    for layer in self.layers:
      shape = layer.build(shape, generator)
    return shape

  def forward(self, x, return_hidden: bool = False):
    hidden = []
    for layer in self.layers:
      x = layer(x)
      hidden.append(x)
    return (x, hidden) if return_hidden else x
