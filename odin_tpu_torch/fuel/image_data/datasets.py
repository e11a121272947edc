"""Procedural disentanglement datasets (a copy of the NumPy renderer,
``FullGridMixin``, ``dSprites`` and ``Shapes3D`` with their small and
one-hot variants, ``odin_tpu/fuel/image_data/datasets.py:203-559``) and the
2-D ``HalfMoons`` (``:671-700``), whose points ``make_moons`` draws as
scikit-learn's function of that name does, without scikit-learn.

The images are rendered on the host from seeded factor draws, exactly as
the JAX package renders them, or read from ``<data path>/dsprites.npz``
(``shapes3d.npz``) where that file exists, as the JAX package reads it.
``full_grid=True`` serves the complete cartesian factor grid from a uint8
``.npy`` cache under the data path, the same file the JAX package writes.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from odin_tpu_torch.fuel.dataset_base import get_partition
from odin_tpu_torch.fuel.image_data._base import ImageDataset
from odin_tpu_torch.utils import get_data_path

__all__ = ["FullGridMixin", "dSprites", "dSpritesSmall", "dSprites0",
           "Shapes3D", "Shapes3DSmall", "Shapes3D0", "HalfMoons",
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


class FullGridMixin:
  """The complete cartesian factor grid of a procedural factor dataset
  (the benchmark protocol: budgets sized to 90 % of the grid).  Needs
  `factor_sizes`, `shape`, `render(factors)`, `seed`, `_cache`, `name` and
  `_image_size`.  The images render once to a uint8 ``.npy`` memmap
  cache under the data path (written to a ``.tmp`` file, then renamed);
  the partitions are a seeded 90/5/5 permutation split, each shuffled
  again with ``seed + 7``."""

  def grid_factors(self) -> np.ndarray:
    """The grid, (prod(factor_sizes), n_factors) int64, in C order (the
    first factor slowest: a row's index is its mixed-radix number)."""
    return np.indices(self.factor_sizes).reshape(
        len(self.factor_sizes), -1).T.astype(np.int64)

  def _grid_cache_path(self) -> str:
    return os.path.join(get_data_path(),
                        f"{self.name}_fullgrid_u8_{self._image_size}.npy")

  def _render_grid_cached(self) -> np.ndarray:
    """The grid's images as uint8 {0, 255} in grid order, rendered into
    the cache at first use and memory-mapped from it."""
    cache = self._grid_cache_path()
    total = int(np.prod(self.factor_sizes))
    shape = (total,) + tuple(self.shape)
    if os.path.exists(cache):
      return np.lib.format.open_memmap(cache, mode="r")
    grid = self.grid_factors()
    out = np.lib.format.open_memmap(cache + ".tmp", mode="w+",
                                    dtype=np.uint8, shape=shape)
    chunk = 16384
    for i in range(0, total, chunk):
      out[i:i + chunk] = (self.render(grid[i:i + chunk]) * 255).astype(
          np.uint8)
    out.flush()
    os.replace(cache + ".tmp", cache)
    return np.lib.format.open_memmap(cache, mode="r")

  def _load_full_grid(self, partition: str):
    key = get_partition(partition, train="train", valid="valid", test="test")
    if key in self._cache:
      return self._cache[key]
    total = int(np.prod(self.factor_sizes))
    imgs = self._render_grid_cached()
    grid = self.grid_factors().astype("float32")
    perm = np.random.RandomState(self.seed).permutation(total)
    n_train = int(0.9 * total)
    n_valid = (total - n_train) // 2
    sl = {"train": perm[:n_train],
          "valid": perm[n_train:n_train + n_valid],
          "test": perm[n_train + n_valid:]}[key]
    x = imgs[np.sort(sl)]  # a sorted gather reads the memmap in order
    y = grid[np.sort(sl)]
    order = np.random.RandomState(self.seed + 7).permutation(len(sl))
    self._cache[key] = (x[order], y[order])
    return self._cache[key]


class dSprites(FullGridMixin, ImageDataset):
  """dSprites (Matthey et al.): 3 shapes x 6 scales x 40 orientations x
  32 x 32 positions.  Images come from ``<data path>/dsprites.npz`` (or
  `path`) where it exists: its ``x_train``/``y_train`` split 80/10/10.
  Otherwise they are rendered procedurally from `n_samples` random factor
  draws per partition (seeded by `seed` and the partition), or, with
  `full_grid`, the complete 737,280-image grid (``FullGridMixin``).
  Labels are the five factor indices as float32; ``create_dataset``
  binarizes by default."""

  factor_names = ["shape", "scale", "orientation", "pos_x", "pos_y"]
  factor_sizes = [3, 6, 40, 32, 32]
  _image_size = 64

  def __init__(self, n_samples: int = 16384, continuous_factors: bool = False,
               path: Optional[str] = None, seed: int = 1,
               full_grid: bool = False):
    super().__init__(seed=seed)
    self.continuous_factors = bool(continuous_factors)
    self.n_samples = int(n_samples)
    self.full_grid = bool(full_grid)
    self.path = path or os.path.join(get_data_path(), "dsprites.npz")
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
    if self.full_grid:
      return self._load_full_grid(partition)
    if not os.path.exists(self.path):
      key = get_partition(partition, train=0, valid=1, test=2)
      if key not in self._cache:
        rng = np.random.RandomState(self.seed + 123 * key)
        f = self._sample_factors(self.n_samples, rng)
        self._cache[key] = (self.render(f), f.astype("float32"))
      return self._cache[key]
    arr = dict(np.load(self.path, allow_pickle=False))
    x, y = arr["x_train"], arr["y_train"]
    key = get_partition(partition, train="train", valid="valid", test="test")
    n = len(x)
    splits = {"train": slice(0, int(0.8 * n)),
              "valid": slice(int(0.8 * n), int(0.9 * n)),
              "test": slice(int(0.9 * n), n)}
    return x[splits[key]], y[splits[key]].astype("float32")

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


class Shapes3D(FullGridMixin, ImageDataset):
  """Shapes3D (Burgess & Kim): 6 factors, rendered procedurally as a
  coloured sprite (object hue, scale, shape, orientation) before a wall and
  a floor of their own hues, from `n_samples` random factor draws per
  partition (seeded by ``seed + 77 * partition``), or the complete
  480,000-image grid with `full_grid`.  Where ``<data path>/shapes3d.npz``
  (or `path`) exists, every partition is its ``x_train``/``y_train``, as
  in the JAX package."""

  factor_names = ["orientation", "scale", "shape", "floor_hue", "wall_hue",
                  "object_hue"]
  factor_sizes = [15, 8, 4, 10, 10, 10]
  _image_size = 64

  def __init__(self, n_samples: int = 8192, path: Optional[str] = None,
               seed: int = 1, full_grid: bool = False):
    super().__init__(seed=seed)
    self.n_samples = int(n_samples)
    self.path = path or os.path.join(get_data_path(), "shapes3d.npz")
    self.full_grid = bool(full_grid)
    self._cache = {}

  @property
  def name(self) -> str:
    return "shapes3d"

  @property
  def shape(self) -> Tuple[int, int, int]:
    return (self._image_size, self._image_size, 3)

  @property
  def labels(self) -> List[str]:
    return list(self.factor_names)

  @staticmethod
  def _hue_to_rgb(h):
    h = np.asarray(h, "float32")[..., None]
    return np.clip(np.stack([
        np.abs(((h[..., 0] * 6) % 6) - 3) - 1,
        2 - np.abs(((h[..., 0] * 6 + 4) % 6) - 3),
        2 - np.abs(((h[..., 0] * 6 + 2) % 6) - 3),
    ], -1), 0, 1)

  def render(self, factors: np.ndarray) -> np.ndarray:
    """factors (n, 6) integer indices -> images (n, 64, 64, 3) in [0, 1]:
    the wall above 65 % of the height, the floor below, the sprite (shapes
    3 and 2 both as the heart) at (0.5, 0.6)."""
    f = np.asarray(factors)
    n = len(f)
    orient = f[:, 0] / self.factor_sizes[0] * 2 * np.pi
    scale = f[:, 1] / max(self.factor_sizes[1] - 1, 1)
    shape_id = np.minimum(f[:, 2], 2)
    floor_h = f[:, 3] / self.factor_sizes[3]
    wall_h = f[:, 4] / self.factor_sizes[4]
    obj_h = f[:, 5] / self.factor_sizes[5]
    mask = _render_shapes2d(shape_id, scale, orient,
                            np.full(n, 0.5, "f"), np.full(n, 0.6, "f"),
                            self._image_size)[..., 0]
    s = self._image_size
    img = np.zeros((n, s, s, 3), "float32")
    horizon = int(s * 0.65)
    img[:, :horizon, :, :] = self._hue_to_rgb(wall_h)[:, None, None, :]
    img[:, horizon:, :, :] = self._hue_to_rgb(floor_h)[:, None, None, :]
    obj_rgb = self._hue_to_rgb(obj_h)[:, None, None, :]
    return np.where(mask[..., None] > 0, obj_rgb, img)

  def _sample_factors(self, n, rng):
    return np.stack([rng.randint(0, k, n) for k in self.factor_sizes], -1)

  def _load(self, partition: str):
    if self.full_grid:
      return self._load_full_grid(partition)
    if os.path.exists(self.path):
      # every partition is the file's train split, as in the JAX package
      arr = dict(np.load(self.path, allow_pickle=False))
      return arr["x_train"], arr["y_train"]
    key = get_partition(partition, train=0, valid=1, test=2)
    if key not in self._cache:
      rng = np.random.RandomState(self.seed + 77 * key)
      f = self._sample_factors(self.n_samples, rng)
      self._cache[key] = (self.render(f), f.astype("float32"))
    return self._cache[key]


class Shapes3DSmall(Shapes3D):
  """Shapes3D with 2,048 images a partition."""

  def __init__(self, n_samples: int = 2048, **kwargs):
    super().__init__(n_samples=n_samples, **kwargs)

  @property
  def name(self):
    return "shapes3dsmall"


class Shapes3D0(Shapes3D):
  """Shapes3D with shape-only one-hot labels (4 shapes); `all_labels=True`
  keeps all six factors as concatenated per-factor one-hots."""

  def __init__(self, all_labels: bool = False, **kwargs):
    super().__init__(**kwargs)
    self.all_labels = bool(all_labels)

  @property
  def name(self):
    return "shapes3d0"

  @property
  def labels(self):
    if self.all_labels:
      return list(self.factor_names)
    return ["cube", "cylinder", "sphere", "round"]

  def _load(self, partition: str):
    x, y = super()._load(partition)
    f = np.asarray(y)
    if self.all_labels:
      return x, np.concatenate(
          [np.eye(k, dtype="float32")[f[:, i].astype(int)]
           for i, k in enumerate(self.factor_sizes)], -1)
    shape_idx = self.factor_names.index("shape")
    k = self.factor_sizes[shape_idx]
    return x, np.eye(k, dtype="float32")[f[:, shape_idx].astype(int)]


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
