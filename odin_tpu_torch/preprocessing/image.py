"""Image preprocessing helpers of the port (PyTorch port of
``odin_tpu/preprocessing/image.py``): reading, resizing, cropping,
rotating and normalising single images on the host with NumPy, SciPy and
PIL (imported when a function needs it, as the JAX package does: where
PIL is missing, those functions raise an ImportError naming it), the
random affine augmentations, and ``batch_resize``, a batch of images
resized on the device with ``jax.image.resize``'s kernels.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from odin_tpu_torch.device import as_tensor, device_of

__all__ = ["read_image", "resize_image", "center_crop", "rotate_image",
           "normalize_image", "batch_resize"]


def _pil():
  try:
    from PIL import Image
  except ImportError as e:
    raise ImportError("this image function needs PIL (the Pillow package), "
                      "which is not installed") from e
  return Image


def read_image(path: str, grayscale: bool = False) -> np.ndarray:
  Image = _pil()
  img = Image.open(path)
  if grayscale:
    img = img.convert("L")
  arr = np.asarray(img)
  if arr.ndim == 2:
    arr = arr[..., None]
  return arr


def resize_image(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
  Image = _pil()
  squeeze = img.shape[-1] == 1
  pil = Image.fromarray(img.squeeze(-1) if squeeze else img)
  out = np.asarray(pil.resize((size[1], size[0]), Image.BILINEAR))
  return out[..., None] if squeeze else out

def center_crop(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
  h, w = img.shape[:2]
  th, tw = size
  i = max((h - th) // 2, 0)
  j = max((w - tw) // 2, 0)
  return img[i:i + th, j:j + tw]


def rotate_image(img: np.ndarray, degrees: float) -> np.ndarray:
  Image = _pil()
  squeeze = img.shape[-1] == 1
  pil = Image.fromarray(img.squeeze(-1) if squeeze else img)
  out = np.asarray(pil.rotate(degrees, Image.BILINEAR))
  return out[..., None] if squeeze else out


def normalize_image(img: np.ndarray, mode: str = "probs") -> np.ndarray:
  img = np.asarray(img, np.float32)
  if img.max() > 1.5:
    img = img / 255.0
  if mode == "tanh":
    return 2.0 * img - 1.0
  if mode == "raster":
    return img * 255.0
  return img


def _triangle(x):
  return torch.clamp(1.0 - torch.abs(x), min=0.0)


def _keys_cubic(x):
  out = ((1.5 * x - 2.5) * x) * x + 1.0
  out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
  return torch.where(x >= 2.0, 0.0, out)


def _lanczos(radius: float):
  def kernel(x):
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    out = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi ** 2 * x ** 2,
                                                1.0), 1.0)
    return torch.where(x > radius, 0.0, out)
  return kernel


_KERNELS = {"linear": _triangle, "bilinear": _triangle,
            "trilinear": _triangle, "triangle": _triangle,
            "cubic": _keys_cubic, "bicubic": _keys_cubic,
            "tricubic": _keys_cubic, "lanczos3": _lanczos(3.0),
            "lanczos5": _lanczos(5.0)}


def _weight_mat(m: int, n: int, kernel, device) -> torch.Tensor:
  """(m, n) float32 weights of `jax.image.resize`'s resample of an axis of
  m samples to n (antialiased): output j samples the input at
  ``(j + 0.5) m / n - 0.5``; a shrinking kernel is widened by m / n; each
  column is normalised to sum 1, and zeroed where it samples outside the
  input."""
  inv_scale = m / n
  kernel_scale = max(inv_scale, 1.0)
  sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * \
      inv_scale - 0.5
  x = torch.abs(sample[None, :] - torch.arange(
      m, dtype=torch.float32, device=device)[:, None]) / kernel_scale
  w = kernel(x)
  total = torch.sum(w, dim=0, keepdim=True)
  w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                  w / torch.where(total != 0, total, 1.0), 0.0)
  inside = (sample >= -0.5) & (sample <= m - 0.5)
  return torch.where(inside[None, :], w, 0.0)


def batch_resize(images, size: Tuple[int, int], method: str = "bilinear",
                 device=None) -> torch.Tensor:
  """(B, H, W, C) images -> (B, size[0], size[1], C) on their device (the
  card for an array), with ``jax.image.resize``'s semantics: 'nearest'
  takes input pixel ``floor((j + 0.5) m / n)``; 'linear' ('bilinear'),
  'cubic' (Keys, a = -0.5) and 'lanczos3'/'lanczos5' resample each
  spatial axis by a separable weight matrix (``_weight_mat``), whose
  kernel is widened when the axis shrinks (antialiasing).  Integer images
  are resized in float32."""
  x = as_tensor(images, device_of(images, device=device))
  if not x.is_floating_point():
    x = x.float()
  b, h, w, c = x.shape
  out_h, out_w = int(size[0]), int(size[1])
  if method == "nearest":
    for axis, (m, n) in ((1, (h, out_h)), (2, (w, out_w))):
      if m != n:
        idx = torch.floor((torch.arange(n, dtype=torch.float32,
                                        device=x.device) + 0.5) * m / n)
        x = torch.index_select(x, axis, idx.long())
    return x
  if method not in _KERNELS:
    raise ValueError(f'Unknown resize method "{method}"')
  kernel = _KERNELS[method]
  if out_h != h:
    x = torch.einsum("bhwc,hk->bkwc", x, _weight_mat(h, out_h, kernel,
                                                     x.device).to(x.dtype))
  if out_w != w:
    x = torch.einsum("bhwc,wk->bhkc", x, _weight_mat(w, out_w, kernel,
                                                     x.device).to(x.dtype))
  return x


def transform_matrix_offset_center(matrix: np.ndarray, x: int, y: int) -> np.ndarray:
  """Recenter an affine matrix on the image center (reference
  ``image.py:50``)."""
  o_x = float(x) / 2 + 0.5
  o_y = float(y) / 2 + 0.5
  offset = np.array([[1, 0, o_x], [0, 1, o_y], [0, 0, 1]])
  reset = np.array([[1, 0, -o_x], [0, 1, -o_y], [0, 0, 1]])
  return offset @ matrix @ reset


def apply_transform(x: np.ndarray, transform_matrix: np.ndarray,
                    fill_mode: str = "nearest", cval: float = 0.0) -> np.ndarray:
  """Apply a 3x3 affine matrix to an HWC image, channel-by-channel
  (reference ``image.py:17``)."""
  from scipy import ndimage
  x = np.asarray(x)
  squeeze = x.ndim == 2
  if squeeze:
    x = x[..., None]
  final_affine = transform_matrix[:2, :2]
  final_offset = transform_matrix[:2, 2]
  out = np.stack([
      ndimage.affine_transform(x[..., c].astype(np.float64), final_affine,
                               final_offset, order=1, mode=fill_mode,
                               cval=cval)
      for c in range(x.shape[-1])], axis=-1).astype(x.dtype)
  return out[..., 0] if squeeze else out


def rotate(x: np.ndarray, rg: float = 20.0, fill_mode: str = "nearest",
           seed=None) -> np.ndarray:
  """Random rotation within +-`rg` degrees (reference ``image.py:59``)."""
  rng = np.random.RandomState(seed)
  theta = np.pi / 180 * rng.uniform(-rg, rg)
  m = np.array([[np.cos(theta), -np.sin(theta), 0],
                [np.sin(theta), np.cos(theta), 0], [0, 0, 1]])
  h, w = np.asarray(x).shape[:2]
  return apply_transform(x, transform_matrix_offset_center(m, h, w),
                         fill_mode)


def shift(x: np.ndarray, wrg: float = 0.1, hrg: float = 0.1,
          fill_mode: str = "nearest", seed=None) -> np.ndarray:
  """Random translation by fractions of width/height (reference
  ``image.py:84``)."""
  rng = np.random.RandomState(seed)
  h, w = np.asarray(x).shape[:2]
  tx = rng.uniform(-hrg, hrg) * h
  ty = rng.uniform(-wrg, wrg) * w
  m = np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]], dtype=np.float64)
  return apply_transform(x, m, fill_mode)


def zoom(x: np.ndarray, zoom_width: float = 0.9, zoom_height: float = 1.1,
         fill_mode: str = "nearest", seed=None) -> np.ndarray:
  """Random zoom sampled between the two factors (reference
  ``image.py:112``)."""
  rng = np.random.RandomState(seed)
  lo, hi = sorted((float(zoom_width), float(zoom_height)))
  zx, zy = rng.uniform(lo, hi, 2)
  m = np.array([[zx, 0, 0], [0, zy, 0], [0, 0, 1]])
  h, w = np.asarray(x).shape[:2]
  return apply_transform(x, transform_matrix_offset_center(m, h, w),
                         fill_mode)


def shear(x: np.ndarray, intensity: float = 0.2, fill_mode: str = "nearest",
          seed=None) -> np.ndarray:
  """Random shear in radians (reference ``image.py:142``)."""
  rng = np.random.RandomState(seed)
  s = rng.uniform(-intensity, intensity)
  m = np.array([[1, -np.sin(s), 0], [0, np.cos(s), 0], [0, 0, 1]])
  h, w = np.asarray(x).shape[:2]
  return apply_transform(x, transform_matrix_offset_center(m, h, w),
                         fill_mode)


__all__ += ["apply_transform", "transform_matrix_offset_center", "rotate",
            "shift", "zoom", "shear"]
