"""Math utilities of the port (PyTorch port of ``odin_tpu/backend/maths.py``):
length normalisation, whitening, the softplus inverse, stable log
reductions, probability-to-score transforms, masks and integer upsampling.

Each function takes a tensor, an array or a list and runs on the device of
a tensor argument; an array or a list goes to the card unless `device` says
otherwise.  Those that JAX computes in float32 (``log_norm``,
``whitening``, ``to_llh``, ``to_llr``, ``renorm_rms``,
``poincare_normalize``) cast to float32; the others keep the input's
floating dtype."""
from __future__ import annotations

import math

import numpy as np
import torch

from odin_tpu_torch.device import as_tensor, device_of

__all__ = ["softplus_inverse", "length_norm", "log_norm", "whitening",
           "logsumexp_mean", "to_llh", "to_llr", "to_sample_weights",
           "renorm_rms", "poincare_normalize", "l2_normalize",
           "calc_white_mat", "reduce_logexp", "apply_mask", "tril_mask",
           "softmin", "upsample"]


def _t(x, device=None, dtype=None) -> torch.Tensor:
  x = as_tensor(x, device_of(x, device=device), dtype)
  if dtype is None and not x.is_floating_point():
    x = x.float()
  return x


def _dims(axis):
  return None if axis is None else (tuple(axis) if isinstance(
      axis, (list, tuple)) else (int(axis),))


def softplus_inverse(x, device=None) -> torch.Tensor:
  """The inverse of softplus, ``log(exp(x) - 1)``, as
  ``x + log(-expm1(-x))``."""
  x = _t(x, device)
  return x + torch.log(-torch.expm1(-x))


def length_norm(x, axis: int = -1, epsilon: float = 1e-12, ord: int = 2,
                device=None) -> torch.Tensor:
  """Unit-length normalisation along `axis` (i-vector post-processing):
  ``x / sqrt(max(sum x², eps))`` for ``ord`` 2, else
  ``x / max((sum |x|^ord)^(1/ord), eps)``."""
  x = _t(x, device)
  if ord == 2:
    norm = torch.sqrt(torch.clamp(torch.sum(x * x, dim=axis, keepdim=True),
                                  min=epsilon))
  else:
    norm = torch.clamp(torch.sum(torch.abs(x) ** ord, dim=axis,
                                 keepdim=True) ** (1.0 / ord), min=epsilon)
  return x / norm


def log_norm(x, axis: int = 1, scale_factor: float = 10000.0,
             device=None) -> torch.Tensor:
  """``log1p(x / sum(x) · scale)`` of count data, in float32."""
  x = _t(x, device, torch.float32)
  s = torch.sum(x, dim=axis, keepdim=True)
  return torch.log1p(x / torch.clamp(s, min=1e-8) * scale_factor)


def whitening(x, mean=None, cov=None, epsilon: float = 1e-5,
              device=None) -> torch.Tensor:
  """ZCA whitening of row vectors: ``(x - mean) V diag(1/sqrt(w + eps))
  Vᵀ`` with ``(w, V)`` the eigen-decomposition of the covariance (the
  rows' own unless `cov` is given), in float32."""
  x = _t(x, device, torch.float32)
  if mean is None:
    mean = torch.mean(x, dim=0, keepdim=True)
  else:
    mean = as_tensor(mean, x.device, torch.float32)
  xc = x - mean
  if cov is None:
    cov = (xc.T @ xc) / x.shape[0]
  else:
    cov = as_tensor(cov, x.device, torch.float32)
  w, v = torch.linalg.eigh(cov)
  W = v @ torch.diag(1.0 / torch.sqrt(w + epsilon)) @ v.T
  return xc @ W


def logsumexp_mean(x, axis: int = 0, device=None) -> torch.Tensor:
  """log-mean-exp along `axis`: the importance-weighted average of IWAE."""
  x = _t(x, device)
  return torch.logsumexp(x, dim=axis) - math.log(float(x.shape[axis]))


def to_llh(x, device=None) -> torch.Tensor:
  """Probabilities -> log-likelihoods: each row normalised to sum 1, then
  ``log(clip(p, 1e-8, 1 - 1e-8))``."""
  x = _t(x, device, torch.float32)
  x = x / torch.sum(x, dim=-1, keepdim=True)
  return torch.log(torch.clamp(x, 1e-8, 1.0 - 1e-8))


def to_llr(x, device=None) -> torch.Tensor:
  """Scores -> log-likelihood ratios of each class against the others:
  ``-logsumexp_{k≠j}(x_k − x_j) + log(max(L − 1, 1))`` for each class j of
  L."""
  x = _t(x, device, torch.float32)
  n = x.shape[-1]
  rest = x[:, None, :] - x[:, :, None]  # [i, j, k] = x_k - x_j
  eye = torch.eye(n, dtype=torch.bool, device=x.device)
  rest = rest.masked_fill(eye, -math.inf)
  return -torch.logsumexp(rest, dim=2) + math.log(float(max(n - 1, 1)))


def to_sample_weights(indices, weights, device=None) -> torch.Tensor:
  """Class indices (or one-hot rows) and per-class weights -> per-sample
  weights (float32)."""
  indices = as_tensor(indices, device_of(indices, weights, device=device))
  if indices.ndim > 1:
    indices = torch.argmax(indices, dim=-1)
  weights = as_tensor(weights, indices.device, torch.float32)
  return weights[indices.long()]


def renorm_rms(x, axis: int = 1, target_rms: float = 1.0,
               device=None) -> torch.Tensor:
  """Scale so that the RMS along `axis` is `target_rms` (a zero RMS is
  left as 1), in float32."""
  x = _t(x, device, torch.float32)
  d = math.sqrt(float(x.shape[axis]))
  rms = torch.sqrt(torch.sum(x ** 2, dim=axis, keepdim=True)) / d
  rms = torch.where(rms == 0.0, torch.ones_like(rms), rms)
  return target_rms * x / rms


def poincare_normalize(x, axis: int = -1, epsilon: float = 1e-6,
                       device=None) -> torch.Tensor:
  """Project onto the Poincaré ball: rows of norm above ``1 - eps`` are
  scaled to that norm (hyperbolic embeddings), in float32."""
  x = _t(x, device, torch.float32)
  norm = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
  max_norm = 1.0 - epsilon
  return torch.where(norm > max_norm, x / norm * max_norm, x)


def l2_normalize(x, axis=None, eps: float = 1e-12,
                 device=None) -> torch.Tensor:
  """``x · rsqrt(max(sum x², eps))`` over `axis` (all axes when None), as
  ``tf.nn.l2_normalize``."""
  x = _t(x, device)
  sq = torch.sum(torch.square(x), dim=_dims(axis), keepdim=True)
  return x * torch.rsqrt(torch.clamp(sq, min=eps))


def calc_white_mat(X, device=None) -> torch.Tensor:
  """The whitening transform ``W = chol(inv(X))`` of a covariance matrix."""
  return torch.linalg.cholesky(torch.linalg.inv(_t(X, device)))


def _mean(x, dim=None, keepdim=False):
  return torch.mean(x, dim=dim, keepdim=keepdim)


def reduce_logexp(x, reduction_function=_mean, axis=None,
                  device=None) -> torch.Tensor:
  """Overflow-safe ``log(reduce(exp(x)))`` for a reduction
  ``f(x, dim=..., keepdim=True)`` (the mean by default), with the size-1
  dims squeezed as ``jnp.squeeze`` does."""
  x = _t(x, device)
  dims = _dims(axis)
  x_max = torch.amax(x, dim=dims, keepdim=True) if dims is not None \
      else torch.amax(x).reshape((1,) * x.ndim)
  y = torch.log(reduction_function(torch.exp(x - x_max), dim=dims,
                                   keepdim=True)) + x_max
  return torch.squeeze(y)


def apply_mask(x, mask, device=None) -> torch.Tensor:
  """Mask trailing feature frames: ``x · mask[..., None]``."""
  x = as_tensor(x, device_of(x, mask, device=device))
  return x * as_tensor(mask, x.device, x.dtype).unsqueeze(-1)


def tril_mask(shape, device=None) -> torch.Tensor:
  """Lower-triangular boolean mask over the last two dims of `shape`."""
  ones = torch.ones(tuple(shape), dtype=torch.int32,
                    device=device_of(device=device))
  return torch.cumsum(ones, dim=-2) >= torch.cumsum(ones, dim=-1)


def softmin(x, axis=None, device=None) -> torch.Tensor:
  """``exp(-x_i) / sum_j exp(-x_j)`` along `axis` (the last by default)."""
  return torch.softmax(-_t(x, device), dim=-1 if axis is None else axis)


def upsample(x, scale, axes, method: str = "nn",
             device=None) -> torch.Tensor:
  """Integer upsampling along `axes`.

  'nn' repeats each element (``[1, 2] -> [1, 1, 2, 2]``), 'repeat' tiles
  the whole axis (``[1, 2] -> [1, 2, 1, 2]``), 'pad_margin' zero-pads
  around the existing content (the extra ``size·(scale-1)`` split with the
  ceiling before and the floor after).
  """
  x = as_tensor(x, device_of(x, device=device))
  axes = [a % x.ndim for a in (axes if isinstance(axes, (list, tuple))
                               else (axes,))]
  scales = list(scale) if isinstance(scale, (list, tuple)) \
      else [int(scale)] * len(axes)
  if method == "nn":
    for a, s in zip(axes, scales):
      x = torch.repeat_interleave(x, int(s), dim=a)
  elif method == "repeat":
    for a, s in zip(axes, scales):
      x = x.repeat([int(s) if i == a else 1 for i in range(x.ndim)])
  elif method == "pad_margin":
    smap = dict(zip(axes, scales))
    pads = []
    for i in reversed(range(x.ndim)):  # F.pad takes the last dim first
      extra = x.shape[i] * (smap[i] - 1) if i in smap else 0
      pads += [int(np.ceil(extra / 2)), int(np.floor(extra / 2))]
    x = torch.nn.functional.pad(x, pads)
  else:
    raise ValueError(f"no support for method={method!r}")
  return x
