"""Image datasets of the port: the ``.npz`` loaders (``NPZImageDataset``
and MNIST, FashionMNIST, BinarizedMNIST, HalfMNIST, BinarizedAlphaDigits,
SVHN, CIFAR10/100/20, CelebA with its small and big variants, Omniglot,
LegoFaces, Kaokore; ``odin_tpu/fuel/image_data/datasets.py:35-200,
761-778``), the procedural disentanglement sets (a copy of the NumPy
renderer, ``FullGridMixin``, ``dSprites`` and ``Shapes3D`` with their
small and one-hot variants, :203-559; ``YDisentanglement`` :704-758), the
half-moons as marker images (``make_halfmoons`` :562, ``HalfMoonsImage``
:630) and the 2-D ``HalfMoons`` (:671-700), whose points ``make_moons``
draws as scikit-learn's function of that name does, without
scikit-learn.

The ``.npz`` loaders read ``<data path>/<name>.npz`` (keys x_train,
y_train, x_test, y_test and optionally x_valid, y_valid); nothing is
downloaded.  The procedural images are rendered on the host from seeded
factor draws, exactly as the JAX package renders them, or read from
``<data path>/dsprites.npz`` (``shapes3d.npz``) where that file exists,
as the JAX package reads it.  ``full_grid=True`` serves the complete
cartesian factor grid from a uint8 ``.npy`` cache under the data path,
the same file the JAX package writes.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from odin_tpu_torch.fuel.dataset_base import get_partition
from odin_tpu_torch.fuel.image_data._base import ImageDataset
from odin_tpu_torch.utils import get_data_path

__all__ = ["NPZImageDataset", "MNIST", "FashionMNIST", "BinarizedMNIST",
           "HalfMNIST", "BinarizedAlphaDigits", "SVHN", "CIFAR10",
           "CIFAR100", "CIFAR20", "CelebA", "CelebASmall", "CelebABig",
           "Omniglot", "LegoFaces", "Kaokore", "FullGridMixin", "dSprites",
           "dSpritesSmall", "dSprites0", "Shapes3D", "Shapes3DSmall",
           "Shapes3D0", "HalfMoons", "HalfMoonsImage", "YDisentanglement",
           "make_moons", "make_halfmoons"]


class NPZImageDataset(ImageDataset):
  """A dataset read from ``<data path>/<name>.npz``.  Where the file has
  no ``x_valid``, the last 10 % of the train split becomes the valid split
  (once: the split arrays replace the cached ones)."""

  _name: str = ""
  _shape: Tuple[int, ...] = ()
  _labels: List[str] = []
  _valid_fraction: float = 0.1

  def __init__(self, path: Optional[str] = None, seed: int = 1):
    super().__init__(seed=seed)
    self.path = path or os.path.join(get_data_path(), f"{self._name}.npz")
    self._cache = None

  @property
  def name(self) -> str:
    return self._name

  @property
  def shape(self):
    return tuple(self._shape)

  @property
  def labels(self):
    return list(self._labels)

  def _arrays(self):
    if self._cache is None:
      if not os.path.exists(self.path):
        raise FileNotFoundError(
            f"dataset '{self._name}' not found at {self.path}; this "
            "environment has no network egress — place an .npz with keys "
            "x_train/y_train/x_test/y_test there (see fuel/image_data "
            "docstring), or use the procedural datasets (dSpritesSmall, "
            "Shapes3DSmall, YDisentanglement, HalfMoons) for testing")
      self._cache = dict(np.load(self.path, allow_pickle=False))
    return self._cache

  def _load(self, partition: str):
    arr = self._arrays()
    if "x_valid" not in arr:
      n = len(arr["x_train"])
      k = int(n * (1 - self._valid_fraction))
      arr["x_valid"] = arr["x_train"][k:]
      arr["x_train"] = arr["x_train"][:k]
      if "y_train" in arr:
        arr["y_valid"] = arr["y_train"][k:]
        arr["y_train"] = arr["y_train"][:k]
    key = get_partition(partition, train="train", valid="valid", test="test")
    return arr[f"x_{key}"], arr.get(f"y_{key}")


class MNIST(NPZImageDataset):
  _name = "mnist"
  _shape = (28, 28, 1)
  _labels = [str(i) for i in range(10)]


class FashionMNIST(NPZImageDataset):
  _name = "fashionmnist"
  _shape = (28, 28, 1)
  _labels = ["T-shirt", "Trouser", "Pullover", "Dress", "Coat", "Sandal",
             "Shirt", "Sneaker", "Bag", "Ankle_boot"]


class BinarizedMNIST(MNIST):
  """MNIST binarised in ``create_dataset`` (``binarize=True`` by
  default)."""
  _name = "binarizedmnist"

  @property
  def binarized(self):
    return True

  def create_dataset(self, *args, **kwargs):
    kwargs.setdefault("binarize", True)
    return super().create_dataset(*args, **kwargs)


class HalfMNIST(MNIST):
  """MNIST with the first half of its train split; valid and test as
  MNIST's."""

  @property
  def name(self) -> str:
    return "halfmnist"

  def _load(self, partition: str):
    x, y = super()._load(partition)
    if get_partition(partition, train=True, valid=False, test=False):
      n = len(x) // 2
      x = x[:n]
      y = None if y is None else y[:n]
    return x, y


class BinarizedAlphaDigits(BinarizedMNIST):
  """Binary 20x16 digits '0'-'9' and capitals 'A'-'Z': where the file
  lacks a valid or a test split, its train arrays are split 70/10/20 into
  train, valid and test."""

  _name = "binaryalphadigits"
  _shape = (20, 16, 1)
  _labels = ([str(i) for i in range(10)] +
             [chr(ord("A") + i) for i in range(26)])

  def _load(self, partition: str):
    arr = self._arrays()
    if "x_valid" not in arr or "x_test" not in arr:
      x, y = arr["x_train"], arr.get("y_train")
      n = len(x)
      a, b = int(0.7 * n), int(0.8 * n)
      arr["x_train"], arr["x_valid"], arr["x_test"] = x[:a], x[a:b], x[b:]
      if y is not None:
        arr["y_train"], arr["y_valid"], arr["y_test"] = y[:a], y[a:b], y[b:]
    key = get_partition(partition, train="train", valid="valid", test="test")
    return arr[f"x_{key}"], arr.get(f"y_{key}")


class SVHN(NPZImageDataset):
  _name = "svhn"
  _shape = (32, 32, 3)
  _labels = [str(i) for i in range(10)]


class CIFAR10(NPZImageDataset):
  _name = "cifar10"
  _shape = (32, 32, 3)
  _labels = ["airplane", "automobile", "bird", "cat", "deer", "dog", "frog",
             "horse", "ship", "truck"]


class CIFAR100(NPZImageDataset):
  _name = "cifar100"
  _shape = (32, 32, 3)
  _labels = [str(i) for i in range(100)]


class CIFAR20(CIFAR100):
  """CIFAR-100's 20 coarse labels."""
  _name = "cifar20"
  _labels = [str(i) for i in range(20)]


class CelebA(NPZImageDataset):
  _name = "celeba"
  _shape = (64, 64, 3)
  _labels = [f"attr{i}" for i in range(40)]


class CelebASmall(CelebA):
  _name = "celebasmall"


class CelebABig(CelebA):
  """CelebA at its original resolution, square-cropped to 178x178x3."""
  _name = "celebabig"
  _shape = (178, 178, 3)


class Omniglot(NPZImageDataset):
  _name = "omniglot"
  _shape = (28, 28, 3)


class LegoFaces(NPZImageDataset):
  """LEGO minifigure faces with multi-hot factor labels (the scraped and
  resized images, from their ``.npz`` cache)."""
  _name = "legofaces"
  _shape = (64, 64, 3)
  _labels = ["eyebrows", "eyes", "glasses", "smile", "frown", "open_mouth",
             "teeth", "beard", "moustache", "lipstick", "angry", "scared",
             "happy", "sad", "curly"]


class Kaokore(NPZImageDataset):
  """Pre-modern Japanese face artworks with gender and status labels."""
  _name = "kaokore"
  _shape = (64, 64, 3)
  _labels = ["male", "female", "noble", "warrior", "incarnation", "commoner"]


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


# matplotlib's 'coolwarm' at the 10 hues of make_halfmoons,
# np.linspace(0, 1, 10), as RGB in [0, 1]
_COOLWARM10 = np.array([
    (0.2298057, 0.298717966, 0.753683153),
    (0.3634607953411765, 0.4847836818509804, 0.9010188868941177),
    (0.5108243242509803, 0.6493966148235294, 0.9850787763764707),
    (0.6672529243333334, 0.7791764569999999, 0.992959213),
    (0.8049647588235295, 0.8516661605568627, 0.9261650744313725),
    (0.9193759889058823, 0.8312727235294118, 0.7828736304470588),
    (0.968203399, 0.7208441, 0.6122929913333334),
    (0.9440545734235294, 0.5531534787490197, 0.4355484903137255),
    (0.8523781350078431, 0.34649194649411763, 0.2803464686980392),
    (0.705673158, 0.01555616, 0.150232812),
])


def make_halfmoons(n_samples_per_factors: int = 200, image_size: int = 64,
                   marker_size: float = 12.0, seed: int = 1,
                   n_cpu: int = 1):
  """Two-moons points drawn as marker images: each sample one point as a
  marker (circle, square, triangle, pentagon) in one of 10 'coolwarm'
  hues on black, (n, s, s, 3) uint8; labels [x, y, moon, hue * 2 - 1,
  marker index] float32.  The JAX package's arrays bit for bit (its
  draws from ``RandomState(seed)``: the markers' and hues' shuffles, then
  ``make_moons``'s seed); `n_cpu` is kept for the signature."""
  rand = np.random.RandomState(seed=seed)
  shapes = ["o", "s", "^", "p"]
  shapes_to_idx = {v: k for k, v in enumerate(shapes)}
  colors = np.linspace(0.0, 1.0, num=10)
  n_samples = n_samples_per_factors * len(shapes) * len(colors)
  shp = np.tile(shapes, [n_samples // len(shapes)])
  col = np.tile(colors, [n_samples // len(colors)])
  rand.shuffle(shp)
  rand.shuffle(col)
  x, y = make_moons(n_samples=n_samples, shuffle=True, noise=0.05,
                    random_state=rand.randint(int(1e8)))
  x = (x - x.min(0, keepdims=True)) / \
      (x.max(0, keepdims=True) - x.min(0, keepdims=True)) * 2.0 - 1.0
  rgb = _COOLWARM10[np.rint(col * 9).astype(int)]
  # marker radius in pixels: a scatter's s=pt^2 area at dpi 200
  radius = np.sqrt(marker_size / np.pi) * (200.0 / 72.0)
  s = image_size
  px = (x + 1.2) / 2.4 * (s - 1)  # data range [-1.2, 1.2] onto [0, s)
  gy, gx = np.mgrid[0:s, 0:s].astype(np.float32)
  X = np.zeros((n_samples, s, s, 3), np.uint8)
  for i in range(n_samples):
    cx, cy = px[i, 0], (s - 1) - px[i, 1]  # image rows grow downward
    dx, dy = gx - cx, gy - cy
    m = shp[i]
    if m == "o":
      mask = dx ** 2 + dy ** 2 <= radius ** 2
    elif m == "s":
      half = radius * np.sqrt(np.pi) / 2.0  # equal-area square
      mask = (np.abs(dx) <= half) & (np.abs(dy) <= half)
    elif m == "^":  # upward triangle: three half-plane tests
      r = radius * 1.4
      mask = ((dy <= r * 0.5) &
              (dy >= -r + np.abs(dx) * np.sqrt(3.0) - r * 0.5))
    else:  # regular pentagon: the edge's distance at each angle
      r = radius * 1.2
      ang = np.arctan2(dy, dx)
      k = np.cos(np.pi / 5) / np.cos(
          (ang - np.pi / 2) % (2 * np.pi / 5) - np.pi / 5)
      mask = np.sqrt(dx ** 2 + dy ** 2) <= r * k
    X[i][mask] = np.round(rgb[i] * 255).astype(np.uint8)
  Y = np.stack([x[:, 0], x[:, 1], y.astype("f"), col * 2.0 - 1.0,
                np.asarray([shapes_to_idx[m] for m in shp], "f")], -1)
  return X, Y.astype("float32")


class HalfMoonsImage(ImageDataset):
  """The half-moons as 64x64x3 marker images (``make_halfmoons``, made at
  first use) with 5 factors [pos_x, pos_y, label, color, shape]; 80 %
  train, 10 % valid, 10 % test."""

  factor_names = ["pos_x", "pos_y", "label", "color", "shape"]

  def __init__(self, n_samples_per_factors: int = 25, seed: int = 1):
    super().__init__(seed=seed)
    self.n_samples_per_factors = int(n_samples_per_factors)
    self._cache = None

  @property
  def name(self):
    return "halfmoonsimage"

  @property
  def shape(self):
    return (64, 64, 3)

  @property
  def labels(self):
    return list(self.factor_names)

  def _all(self):
    if self._cache is None:
      self._cache = make_halfmoons(self.n_samples_per_factors,
                                   seed=self.seed)
    return self._cache

  def _load(self, partition: str):
    X, Y = self._all()
    n = len(X)
    sl = get_partition(partition, train=slice(0, int(0.8 * n)),
                       valid=slice(int(0.8 * n), int(0.9 * n)),
                       test=slice(int(0.9 * n), n))
    return X[sl].astype("float32") / 255.0, Y[sl]


class YDisentanglement(ImageDataset):
  """Images of the letter Y with rotation (16), scale (8), pos_x (16) and
  pos_y (16) factors drawn at random, `n_samples` a partition, each
  partition from its own seed."""

  factor_names = ["rotation", "scale", "pos_x", "pos_y"]
  factor_sizes = [16, 8, 16, 16]

  def __init__(self, n_samples: int = 4096, image_size: int = 32,
               seed: int = 1):
    super().__init__(seed=seed)
    self.n_samples = int(n_samples)
    self.image_size = int(image_size)
    self._cache = {}

  @property
  def name(self):
    return "ydisentanglement"

  @property
  def shape(self):
    return (self.image_size, self.image_size, 1)

  @property
  def labels(self):
    return list(self.factor_names)

  def render(self, factors):
    """(n, s, s, 1) float32 in {0, 1} of the factor indices (n, 4)."""
    f = np.asarray(factors)
    s = self.image_size
    rot = f[:, 0] / self.factor_sizes[0] * 2 * np.pi
    scale = 0.2 + 0.5 * f[:, 1] / max(self.factor_sizes[1] - 1, 1)
    px = 0.25 + 0.5 * f[:, 2] / max(self.factor_sizes[2] - 1, 1)
    py = 0.25 + 0.5 * f[:, 3] / max(self.factor_sizes[3] - 1, 1)
    yy, xx = np.mgrid[0:s, 0:s].astype("f") / (s - 1)
    dx = xx[None] - px[:, None, None]
    dy = yy[None] - py[:, None, None]
    c, si = np.cos(rot)[:, None, None], np.sin(rot)[:, None, None]
    u = (c * dx + si * dy) / scale[:, None, None]
    v = (-si * dx + c * dy) / scale[:, None, None]
    w = 0.18
    stem = (np.abs(u) < w) & (v > 0) & (v < 1.0)
    arm1 = (np.abs(u - 0.5 * -v) < w) & (v <= 0) & (v > -1.0)
    arm2 = (np.abs(u - 0.5 * v) < w) & (v <= 0) & (v > -1.0)
    return (stem | arm1 | arm2).astype("float32")[..., None]

  def _load(self, partition: str):
    key = get_partition(partition, train=0, valid=1, test=2)
    if key not in self._cache:
      rng = np.random.RandomState(self.seed + 31 * key)
      f = np.stack([rng.randint(0, k, self.n_samples)
                    for k in self.factor_sizes], -1)
      self._cache[key] = (self.render(f), f.astype("float32"))
    return self._cache[key]
