"""Procedural dSprites (a copy of the NumPy renderer and of ``dSprites``'s
procedural branch, ``odin_tpu/fuel/image_data/datasets.py:203-436``), with
``dSpritesSmall`` and ``dSprites0``; the 2-D ``HalfMoons`` (``:671-700``),
whose points ``make_moons`` draws as scikit-learn's function of that name
does, without scikit-learn.

The images are rendered on the host from seeded factor draws, exactly as
the JAX package renders them.  Not ported yet: the official ``.npz``
loader and the full 737,280-image factor grid (``full_grid``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from odin_tpu_torch.fuel.dataset_base import get_partition
from odin_tpu_torch.fuel.image_data._base import ImageDataset

__all__ = ["dSprites", "dSpritesSmall", "dSprites0", "HalfMoons",
           "make_moons"]


def _render_shapes2d(shape_id, scale, orientation, pos_x, pos_y,
                     image_size: int = 64) -> np.ndarray:
  """Vectorised renderer of dSprites-style binary sprites (square /
  ellipse / heart) -> (n, image_size, image_size, 1) float32 in {0, 1}.

  float32 throughout (an int / int division would promote to float64, far
  slower elementwise); each sprite is rendered only with its own shape's
  implicit function, in blocks of 512 sprites so that every temporary
  stays near cache size."""
  f32 = np.float32
  shape_id = np.asarray(shape_id)
  n = len(shape_id)
  yy, xx = np.mgrid[0:image_size, 0:image_size].astype(f32)
  yy = (yy / f32(image_size - 1)).ravel()[None]   # (1, P)
  xx = (xx / f32(image_size - 1)).ravel()[None]
  cx = np.asarray(pos_x, f32)[:, None]
  cy = np.asarray(pos_y, f32)[:, None]
  # sprite half-size in [0.06, 0.24]
  s = np.asarray(scale, f32)[:, None] * f32(0.18) + f32(0.06)
  th = np.asarray(orientation, f32)[:, None]
  out = np.zeros((n, image_size * image_size), f32)
  for sid in np.unique(shape_id):
    all_rows = np.nonzero(shape_id == sid)[0]
    for c0 in range(0, len(all_rows), 512):
      rows = all_rows[c0:c0 + 512]
      dx = xx - cx[rows]                 # (R, P)
      dy = yy - cy[rows]
      cth, sth = np.cos(th[rows]), np.sin(th[rows])
      u = (cth * dx + sth * dy) / s[rows]
      v = (cth * dy - sth * dx) / s[rows]
      if sid == 0:
        mask = (np.abs(u) <= 1.0) & (np.abs(v) <= 1.0)
      elif sid == 1:
        vv = v / f32(0.6)
        mask = (u * u + vv * vv) <= 1.0
      else:
        # implicit heart curve: (x^2 + y^2 - 1)^3 - x^2 y^3 <= 0 (y up)
        hu = u * f32(1.2)
        hv = -v * f32(1.2) + f32(0.2)
        hu2 = hu * hu
        hv2 = hv * hv
        t = hu2 + hv2 - f32(1.0)
        mask = (t * t * t - hu2 * (hv2 * hv)) <= 0.0
      out[rows] = mask
  return out.reshape(n, image_size, image_size, 1)


class dSprites(ImageDataset):
  """dSprites (Matthey et al.): 3 shapes x 6 scales x 40 orientations x
  32 x 32 positions, rendered procedurally from `n_samples` random factor
  draws per partition (seeded by `seed` and the partition).  Labels are
  the five factor indices as float32; ``create_dataset`` binarizes by
  default."""

  factor_names = ["shape", "scale", "orientation", "pos_x", "pos_y"]
  factor_sizes = [3, 6, 40, 32, 32]
  _image_size = 64

  def __init__(self, n_samples: int = 16384, continuous_factors: bool = False,
               path: Optional[str] = None, seed: int = 1,
               full_grid: bool = False):
    if path is not None or full_grid:
      raise NotImplementedError("the official .npz file and the full factor "
                                "grid of dSprites are not ported yet")
    super().__init__(seed=seed)
    self.continuous_factors = bool(continuous_factors)
    self.n_samples = int(n_samples)
    self._cache = {}

  @property
  def name(self) -> str:
    return "dsprites"

  @property
  def shape(self) -> Tuple[int, int, int]:
    return (self._image_size, self._image_size, 1)

  @property
  def labels(self) -> List[str]:
    return list(self.factor_names)

  def _sample_factors(self, n, rng):
    return np.stack([rng.randint(0, k, n) for k in self.factor_sizes], -1)

  def _factors_to_values(self, f):
    shape_id = f[:, 0]
    scale = f[:, 1] / max(self.factor_sizes[1] - 1, 1)
    orient = f[:, 2] / self.factor_sizes[2] * 2 * np.pi
    pos_x = 0.15 + 0.7 * f[:, 3] / max(self.factor_sizes[3] - 1, 1)
    pos_y = 0.15 + 0.7 * f[:, 4] / max(self.factor_sizes[4] - 1, 1)
    return shape_id, scale, orient, pos_x, pos_y

  def render(self, factors: np.ndarray) -> np.ndarray:
    """factors (n, 5) integer indices -> images (n, 64, 64, 1)."""
    return _render_shapes2d(*self._factors_to_values(np.asarray(factors)),
                            image_size=self._image_size)

  def _load(self, partition: str):
    key = get_partition(partition, train=0, valid=1, test=2)
    if key not in self._cache:
      rng = np.random.RandomState(self.seed + 123 * key)
      f = self._sample_factors(self.n_samples, rng)
      self._cache[key] = (self.render(f), f.astype("float32"))
    return self._cache[key]

  def numpy(self, partition: str = "train", n: Optional[int] = None,
            inc_labels: bool = True):
    """A partition as arrays: images (n, 64, 64, 1) float32 in {0, 1},
    and the labels with `inc_labels`."""
    return super().numpy(partition, n, inc_labels)

  def create_dataset(self, *args, **kwargs):
    kwargs.setdefault("binarize", True)
    return super().create_dataset(*args, **kwargs)


class dSpritesSmall(dSprites):
  """dSprites with 4,096 images a partition."""

  def __init__(self, n_samples: int = 4096, **kwargs):
    super().__init__(n_samples=n_samples, **kwargs)

  @property
  def name(self):
    return "dspritessmall"


class dSprites0(dSprites):
  """dSprites with shape-only one-hot labels; `all_labels=True` keeps all
  five factors as concatenated per-factor one-hots."""

  def __init__(self, all_labels: bool = False, **kwargs):
    kwargs.pop("continuous_factors", None)
    super().__init__(**kwargs)
    self.all_labels = bool(all_labels)

  @property
  def name(self):
    return "dsprites0"

  @property
  def labels(self):
    if self.all_labels:
      return list(self.factor_names)
    return ["square", "ellipse", "heart"]

  def _onehot_factors(self, f):
    return np.concatenate(
        [np.eye(k, dtype="float32")[f[:, i].astype(int)]
         for i, k in enumerate(self.factor_sizes)], -1)

  def _load(self, partition: str):
    x, y = super()._load(partition)
    f = np.asarray(y)
    if self.all_labels:
      return x, self._onehot_factors(f)
    return x, np.eye(3, dtype="float32")[f[:, 0].astype(int)]


def make_moons(n_samples: int = 100, shuffle: bool = True,
               noise: Optional[float] = None, random_state: int = None):
  """Two interleaving half circles: (X (n, 2) float64, y (n,) int64), the
  same arrays as ``sklearn.datasets.make_moons`` for the same arguments
  (its draws from a ``RandomState(random_state)``: the shuffle's
  permutation, then the noise)."""
  n_out = n_samples // 2
  n_in = n_samples - n_out
  rng = random_state if isinstance(random_state, np.random.RandomState) \
      else np.random.RandomState(random_state)
  t_out, t_in = np.linspace(0, np.pi, n_out), np.linspace(0, np.pi, n_in)
  x = np.vstack([np.append(np.cos(t_out), 1 - np.cos(t_in)),
                 np.append(np.sin(t_out), 1 - np.sin(t_in) - 0.5)]).T
  y = np.hstack([np.zeros(n_out, dtype=np.int64),
                 np.ones(n_in, dtype=np.int64)])
  if shuffle:
    order = np.arange(n_samples)
    rng.shuffle(order)
    x, y = x[order], y[order]
  if noise is not None:
    x = x + rng.normal(scale=noise, size=x.shape)
  return x, y


class HalfMoons(ImageDataset):
  """The 2-D two-moons toy: `n_samples` points with Gaussian `noise`, 80 %
  train, 10 % valid, 10 % test; labels the moon (one-hot in
  ``create_dataset``)."""

  def __init__(self, n_samples: int = 3200, noise: float = 0.05,
               seed: int = 1):
    super().__init__(seed=seed)
    x, y = make_moons(n_samples=n_samples, noise=noise, random_state=seed)
    self._x = x.astype("float32")
    self._y = y.astype("int64")

  @property
  def name(self) -> str:
    return "halfmoons"

  @property
  def shape(self) -> Tuple[int]:
    return (2,)

  @property
  def labels(self) -> List[str]:
    return ["moon0", "moon1"]

  def normalize255(self, x: np.ndarray) -> np.ndarray:
    return np.asarray(x, "float32")

  def _load(self, partition: str):
    n = len(self._x)
    sl = get_partition(partition, train=slice(0, int(0.8 * n)),
                       valid=slice(int(0.8 * n), int(0.9 * n)),
                       test=slice(int(0.9 * n), n))
    return self._x[sl], self._y[sl]
