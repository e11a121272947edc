"""Network layers of the port (PyTorch port of ``odin_tpu/networks/base.py``:
the layers, ``SpaceToDepthConv`` :108, the subpixel ``ConvTranspose``
:148-256, ``LogNorm`` :286, ``Dropout`` :297, ``SkipSequential`` :314, the
factories :359-425 and ``NetConf`` :426).

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
import dataclasses
import math
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "Dense", "GRUCell", "Conv", "SpaceToDepthConv", "ConvTranspose",
    "Flatten", "Reshape", "CenterAt0", "LogNorm", "Dropout",
    "Lambda", "BatchNorm", "SequentialNetwork", "SkipSequential",
    "dense_network", "conv_network", "deconv_network", "NetConf",
    "get_activation", "same_padding", "conv_transpose_padding",
    "collecting_updates", "record_update", "layer_noise",
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
  itself, and it draws its kernel with flax's default LeCun init.
  ``groups`` is flax's ``feature_group_count`` (the weight is (out,
  in / groups, kh, kw)); a subclass standing for a flax wrapper of
  ``nn.Conv`` that keeps flax's LeCun init sets ``he_init = False``."""

  he_init = True

  def __init__(self, filters: int, kernel_size=3, strides=1, activation=None,
               padding: str = "SAME", use_bias: bool = True,
               bare: bool = False, groups: int = 1):
    super().__init__()
    self.filters = int(filters)
    self.kernel_size = _pair(kernel_size)
    self.strides = _pair(strides)
    self.activation = activation
    self.padding = str(padding).upper()
    self.use_bias = bool(use_bias)
    self.bare = bool(bare)
    self.groups = int(groups)

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
    cg = c // self.groups
    self.weight = _new_param((self.filters, cg, kh, kw))
    # he_normal, or flax's lecun_normal for a bare nn.Conv
    he = self.he_init and not self.bare
    _variance_scaling_(self.weight, 2.0 if he else 1.0, cg * kh * kw,
                       generator)
    self.bias = nn.Parameter(torch.zeros(self.filters)) if self.use_bias else None
    (ph, qh), (pw, qw) = self._pads(h, w)
    sh, sw = self.strides
    return ((h + ph + qh - kh) // sh + 1, (w + pw + qw - kw) // sw + 1,
            self.filters)

  def _kernel(self):
    return self.weight

  def forward(self, x):
    (ph, qh), (pw, qw) = self._pads(x.shape[1], x.shape[2])
    y = x.permute(0, 3, 1, 2)
    if ph == qh and pw == qw:
      y = F.conv2d(y, self._kernel(), self.bias, self.strides, (ph, pw),
                   groups=self.groups)
    else:
      y = F.conv2d(F.pad(y, (pw, qw, ph, qh)), self._kernel(), self.bias,
                   self.strides, groups=self.groups)
    return get_activation(self.activation)(y.permute(0, 2, 3, 1))


class SpaceToDepthConv(Conv):
  """The exact rewrite of ``Conv(filters, 4, 2, SAME)``: zero-pad by 1,
  space-to-depth in 2 x 2 blocks, then a kernel-2 stride-1 VALID
  convolution whose taps are the same (4, 4, C, F) kernel regrouped by row
  and column parity.  The same outputs (to float32 rounding) and the same
  parameters as the plain ``Conv``, held as the JAX module holds them
  (its own ``kernel`` and ``bias``, no ``Conv_0``).  Even H and W."""

  def __init__(self, filters: int, activation=None, use_bias: bool = True):
    super().__init__(filters, 4, 2, activation, "SAME", use_bias, bare=True)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    h, w, c = (int(i) for i in in_shape)
    if h % 2 or w % 2:
      raise ValueError(f"SpaceToDepthConv needs even H and W, got {h}x{w}")
    self.weight = _new_param((self.filters, c, 4, 4))
    _variance_scaling_(self.weight, 2.0, c * 16, generator)  # he_normal
    self.bias = (nn.Parameter(torch.zeros(self.filters)) if self.use_bias
                 else None)
    return h // 2, w // 2, self.filters

  def forward(self, x):
    b, h, w, c = x.shape
    f = self.filters
    # w2[f, (di, dj, c), a, b] = weight[f, c, 2a + di, 2b + dj]
    w2 = self.weight.reshape(f, c, 2, 2, 2, 2).permute(0, 3, 5, 1, 2, 4)
    w2 = w2.reshape(f, 4 * c, 2, 2)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    h2, ww2 = (h + 2) // 2, (w + 2) // 2
    xs = xp.reshape(b, h2, 2, ww2, 2, c).permute(0, 2, 4, 5, 1, 3)
    xs = xs.reshape(b, 4 * c, h2, ww2)  # NCHW, channel = (di, dj, c)
    y = F.conv2d(xs, w2, self.bias)
    return get_activation(self.activation)(y.permute(0, 2, 3, 1))


def _subpixel_taps(k: int, s: int):
  """Per output parity d: the (input offset o, kernel tap i) pairs of a
  SAME transposed convolution, ``y[s·a + d] = Σ_o x[a + o] · W[i]``, and
  the range of o."""
  p0 = k - 1 - (k - s) // 2
  per_d, omin, omax = [], 0, 0
  for d in range(s):
    ok = [((d + kk - p0) // s, kk) for kk in range(k)
          if (d + kk - p0) % s == 0]
    per_d.append(ok)
    omin = min([omin] + [o for o, _ in ok])
    omax = max([omax] + [o for o, _ in ok])
  return per_d, omin, omax


def _subpixel_maps(k: int, s: int):
  """(tap index map, mask, o range) over (offset - omin, parity)."""
  per_d, omin, omax = _subpixel_taps(k, s)
  n = omax - omin + 1
  idx, msk = np.zeros((n, s), np.int64), np.zeros((n, s), np.float32)
  for d in range(s):
    for o, i in per_d[d]:
      idx[o - omin, d], msk[o - omin, d] = i, 1.0
  return idx, msk, omin, omax


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

  ``subpixel=True`` runs the exact parity-decomposed form where it applies
  (SAME padding, a stride above 1, each kernel dim at least its stride):
  one dense stride-1 convolution to ``sh·sw·F`` channels whose taps are
  the parity slices of the same kernel, then depth-to-space.  Same
  parameters, same outputs to float32 rounding.
  """

  he_init = True  # as Conv's

  def __init__(self, filters: int, kernel_size=3, strides=1, activation=None,
               padding: str = "SAME", use_bias: bool = True,
               bare: bool = False, subpixel: bool = False):
    super().__init__()
    self.subpixel = bool(subpixel)
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
    he = self.he_init and not self.bare
    _variance_scaling_(self.weight, 2.0 if he else 1.0, c * kh * kw,
                       generator)
    self.bias = nn.Parameter(torch.zeros(self.filters)) if self.use_bias else None
    out = []
    for size, k, s, p, op, crop in zip((h, w), self.kernel_size, self.strides,
                                       self._torch_padding,
                                       self._output_padding, self._crop):
      out.append((size - 1) * s - 2 * p + k + op - crop)
    return tuple(out) + (self.filters,)

  @property
  def uses_subpixel(self) -> bool:
    return (self.subpixel and self.padding == "SAME"
            and max(self.strides) > 1
            and all(k >= s for k, s in zip(self.kernel_size, self.strides)))

  def _subpixel(self, x):
    (kh, kw), (sh, sw) = self.kernel_size, self.strides
    b, h, w, c = x.shape
    f = self.filters
    kernel = self.weight.flip(2, 3).permute(2, 3, 0, 1)  # flax (kh, kw, C, F)
    ih, mh, oh0, oh1 = _subpixel_maps(kh, sh)
    iw, mw, ow0, ow1 = _subpixel_maps(kw, sw)
    dev = kernel.device
    ih, iw = torch.from_numpy(ih).to(dev), torch.from_numpy(iw).to(dev)
    mask = torch.from_numpy(mh[:, None, :, None, None, None] *
                            mw[None, :, None, :, None, None]).to(
                                device=dev, dtype=kernel.dtype)
    g = kernel[ih[:, None, :, None], iw[None, :, None, :]] * mask
    # (nth, ntw, sh, sw, C, F) -> OIHW (sh·sw·F, C, nth, ntw)
    nth, ntw = g.shape[0], g.shape[1]
    k2 = g.permute(2, 3, 5, 4, 0, 1).reshape(sh * sw * f, c, nth, ntw)
    xp = F.pad(x, (0, 0, -ow0, ow1, -oh0, oh1)).permute(0, 3, 1, 2)
    z = F.conv2d(xp, k2)  # (B, sh·sw·F, H, W)
    y = z.reshape(b, sh, sw, f, h, w).permute(0, 4, 1, 5, 2, 3)
    y = y.reshape(b, h * sh, w * sw, f)
    return y + self.bias if self.bias is not None else y

  def forward(self, x):
    if self.uses_subpixel:
      return get_activation(self.activation)(self._subpixel(x))
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


class LogNorm(nn.Module):
  """log1p count normalisation: ``log1p(x / sum(x) * scale_factor)`` over
  the last axis."""

  def __init__(self, scale_factor: float = 10000.0):
    super().__init__()
    self.scale_factor = float(scale_factor)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    return tuple(in_shape)

  def forward(self, x):
    s = torch.sum(x, dim=-1, keepdim=True)
    return torch.log1p(x / torch.clamp(s, min=1e-8) * self.scale_factor)


class Dropout(nn.Module):
  """flax's ``Dropout``: in training mode each element is kept where a
  uniform from the step's noise (``layer_noise``) is below ``1 - rate``,
  as ``jax.random.bernoulli`` draws, and scaled by ``1 / (1 - rate)``;
  in eval mode the identity."""

  def __init__(self, rate: float = 0.5):
    super().__init__()
    self.rate = float(rate)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    return tuple(in_shape)

  def forward(self, x):
    if not self.training or self.rate == 0.0:
      return x
    if self.rate >= 1.0:
      return torch.zeros_like(x)
    noise = layer_noise()
    if noise is None:
      raise RuntimeError("Dropout in training mode draws from the step's "
                         "noise: call it through the model's step")
    keep = 1.0 - self.rate
    u = noise.uniform(tuple(x.shape), x.dtype, x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


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
  ones.  ``bare`` marks one of flax's own ``nn.BatchNorm`` layers (inside
  a residual block: its flax path has no ``BatchNorm_0``)."""

  collection = "batch_stats"

  def __init__(self, momentum: float = 0.99, epsilon: float = 1e-5,
               bare: bool = False):
    super().__init__()
    self.momentum = float(momentum)
    self.epsilon = float(epsilon)
    self.bare = bool(bare)

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


class SkipSequential(SequentialNetwork):
  """The skip-generator decoder: its input, flattened, is projected onto
  every 4-d output of a layer (``skip_proj_{i}``, a Dense to that
  output's channels, made in ``build`` only for those layers) and added,
  followed by an ELU."""

  def build(self, in_shape: Shape, generator=None) -> Shape:
    z = int(np.prod(in_shape))
    shape = tuple(in_shape)
    for i, layer in enumerate(self.layers):
      shape = layer.build(shape, generator)
      if len(shape) == 3:
        proj = Dense(shape[-1], bare=True)
        proj.build((z,), generator)
        self.add_module(f"skip_proj_{i}", proj)
    return shape

  def forward(self, x, return_hidden: bool = False):
    if return_hidden:
      raise ValueError("SkipSequential has no hidden outputs to return")
    z = x.reshape(x.shape[0], -1)
    for i, layer in enumerate(self.layers):
      x = layer(x)
      if x.ndim == 4:
        proj = getattr(self, f"skip_proj_{i}")(z)
        x = F.elu(x + proj[:, None, None, :])
    return x


def dense_network(units: Sequence[int], activation="relu",
                  batchnorm: bool = False, dropout: float = 0.0,
                  flatten_inputs: bool = True,
                  input_dropout: float = 0.0) -> list:
  """The layers of an MLP: [Flatten], [Dropout], then a Dense a unit count
  ([BatchNorm, the activation], [Dropout])."""
  layers: list = []
  if flatten_inputs:
    layers.append(Flatten())
  if input_dropout > 0:
    layers.append(Dropout(input_dropout))
  for u in units:
    layers.append(Dense(int(u), activation=None if batchnorm else activation))
    if batchnorm:
      layers.append(BatchNorm())
      layers.append(Lambda(get_activation(activation)))
    if dropout > 0:
      layers.append(Dropout(dropout))
  return layers


def _per_layer(v, n):
  return list(v) if isinstance(v, (list, tuple)) else [v] * n


def conv_network(filters: Sequence[int], kernel_size=3, strides=2,
                 activation="relu", batchnorm: bool = False,
                 dropout: float = 0.0, flatten_outputs: bool = True) -> list:
  """The layers of a CNN: a Conv a filter count ([BatchNorm, the
  activation], [Dropout]), then [Flatten]."""
  n = len(filters)
  layers: list = []
  for f, k, st in zip(filters, _per_layer(kernel_size, n),
                      _per_layer(strides, n)):
    layers.append(Conv(int(f), k, st,
                       activation=None if batchnorm else activation))
    if batchnorm:
      layers.append(BatchNorm())
      layers.append(Lambda(get_activation(activation)))
    if dropout > 0:
      layers.append(Dropout(dropout))
  if flatten_outputs:
    layers.append(Flatten())
  return layers


def deconv_network(filters: Sequence[int], kernel_size=3, strides=2,
                   activation="relu", batchnorm: bool = False,
                   dropout: float = 0.0) -> list:
  """The layers of a transposed CNN, as ``conv_network`` without the
  Flatten."""
  n = len(filters)
  layers: list = []
  for f, k, st in zip(filters, _per_layer(kernel_size, n),
                      _per_layer(strides, n)):
    layers.append(ConvTranspose(int(f), k, st,
                                activation=None if batchnorm else activation))
    if batchnorm:
      layers.append(BatchNorm())
      layers.append(Lambda(get_activation(activation)))
    if dropout > 0:
      layers.append(Dropout(dropout))
  return layers


@dataclasses.dataclass
class NetConf:
  """A network's configuration: ``create_network()`` builds the MLP
  ('dense'), CNN ('conv') or transposed CNN ('deconv');
  ``create_decoder_network(output_shape)`` its mirror image ending at
  `output_shape`."""

  units: Union[int, Sequence[int]] = 64
  kernel: Union[int, Sequence[int]] = 3
  strides: Union[int, Sequence[int]] = 1
  activation: Union[str, Callable] = "relu"
  batchnorm: bool = False
  input_dropout: float = 0.0
  dropout: float = 0.0
  network: str = "dense"  # 'dense' | 'conv' | 'deconv'
  flatten_inputs: bool = True
  name: Optional[str] = None

  def _units(self):
    return [self.units] if isinstance(self.units, int) else list(self.units)

  def create_network(self, name: Optional[str] = None) -> SequentialNetwork:
    units = self._units()
    if self.network == "dense":
      layers = dense_network(units, self.activation, self.batchnorm,
                             self.dropout, self.flatten_inputs,
                             self.input_dropout)
    elif self.network == "conv":
      layers = conv_network(units, self.kernel, self.strides, self.activation,
                            self.batchnorm, self.dropout)
    elif self.network == "deconv":
      layers = deconv_network(units, self.kernel, self.strides,
                              self.activation, self.batchnorm, self.dropout)
    else:
      raise ValueError(f"unknown network type {self.network}")
    return SequentialNetwork(layers)

  def create_decoder_network(self, output_shape: Sequence[int],
                             name: Optional[str] = None
                             ) -> SequentialNetwork:
    rev = list(reversed(self._units()))
    if self.network == "dense":
      layers = dense_network(rev, self.activation, self.batchnorm,
                             self.dropout, flatten_inputs=False)
      layers.append(Dense(int(np.prod(output_shape)), activation=None))
      layers.append(Reshape(tuple(output_shape)))
    else:
      layers = deconv_network(rev, self.kernel, self.strides,
                              self.activation, self.batchnorm, self.dropout)
      layers.append(Conv(int(output_shape[-1]), 1, 1, activation=None))
    return SequentialNetwork(layers)
