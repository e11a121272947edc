"""The port's ``.npz`` image loaders and procedural image sets against the
JAX package's, on small ``.npz`` files each test writes under a temporary
``$ODIN_TPU_HOME/datasets`` (nothing is downloaded): every partition
bit for bit, the 10 % valid split of a file without one (made once),
HalfMNIST's halving, BinarizedAlphaDigits' 70/10/20 split, binarising,
the missing-file error, the registry, and ``make_halfmoons``,
``HalfMoonsImage`` and ``YDisentanglement`` bit for bit."""
import os

import numpy as np
import pytest

import odin_tpu.fuel as jfuel
import odin_tpu_torch.fuel as pfuel

LOADERS = ["MNIST", "FashionMNIST", "BinarizedMNIST", "HalfMNIST",
           "BinarizedAlphaDigits", "SVHN", "CIFAR10", "CIFAR100", "CIFAR20",
           "CelebA", "CelebASmall", "CelebABig", "Omniglot", "LegoFaces",
           "Kaokore"]


@pytest.fixture
def home(tmp_path, monkeypatch):
  monkeypatch.setenv("ODIN_TPU_HOME", str(tmp_path))
  os.makedirs(tmp_path / "datasets", exist_ok=True)
  return tmp_path / "datasets"


def write(home, cls, n_train=50, n_test=12, valid=0, seed=0, labels=True):
  """A file of `cls`'s name and shape: uint8 images, integer labels."""
  rs = np.random.RandomState(seed)
  shape = tuple(getattr(pfuel, cls)._shape)
  arrays = {}
  for part, n in (("train", n_train), ("test", n_test), ("valid", valid)):
    if n:
      arrays[f"x_{part}"] = rs.randint(0, 256, (n,) + shape).astype(np.uint8)
      if labels:
        arrays[f"y_{part}"] = rs.randint(0, 10, n).astype(np.int64)
  np.savez(home / f"{getattr(pfuel, cls)._name}.npz", **arrays)
  return arrays


def partitions(ds):
  return {p: ds._load(p) for p in ("train", "valid", "test")}


def same(a, b):
  assert (a is None) == (b is None)
  if a is not None:
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("cls", LOADERS)
def test_loader_matches_jax(home, cls):
  write(home, cls)
  got, want = getattr(pfuel, cls)(), getattr(jfuel, cls)()
  assert got.name == want.name and got.shape == tuple(want.shape)
  assert got.labels == list(want.labels)
  assert got.path == want.path
  g, w = partitions(got), partitions(want)
  for p in g:
    same(g[p][0], w[p][0])
    same(g[p][1], w[p][1])
  assert pfuel.get_dataset(cls.lower()).__class__ is getattr(pfuel, cls)


def test_valid_split_made_once(home):
  """Without x_valid the last 10 % of train is valid, once: a second
  train read does not split again (JAX's cached dict is split in
  place)."""
  arrays = write(home, "MNIST", n_train=50)
  ds = pfuel.MNIST()
  x1, y1 = ds._load("train")
  xv, yv = ds._load("valid")
  x2, _ = ds._load("train")
  assert len(x1) == len(x2) == 45 and len(xv) == 5
  assert np.array_equal(x1, arrays["x_train"][:45])
  assert np.array_equal(yv, arrays["y_train"][45:])
  # with x_valid in the file, nothing is split
  arrays = write(home, "SVHN", n_train=30, valid=7)
  assert len(pfuel.SVHN()._load("train")[0]) == 30
  assert np.array_equal(pfuel.SVHN()._load("valid")[0], arrays["x_valid"])


def test_halfmnist_halves_train_only(home):
  write(home, "MNIST", n_train=50, n_test=12)
  ds, full = pfuel.HalfMNIST(), pfuel.MNIST()
  assert ds.name == "halfmnist"
  assert len(ds._load("train")[0]) == 45 // 2
  assert np.array_equal(ds._load("train")[0], full._load("train")[0][:22])
  assert len(ds._load("valid")[0]) == 5 and len(ds._load("test")[0]) == 12


def test_alpha_digits_split(home):
  """One array split 70/10/20 into train, valid and test."""
  arrays = write(home, "BinarizedAlphaDigits", n_train=40, n_test=0)
  got = partitions(pfuel.BinarizedAlphaDigits())
  assert [len(got[p][0]) for p in ("train", "valid", "test")] == [28, 4, 8]
  assert np.array_equal(got["test"][0], arrays["x_train"][32:])
  assert pfuel.get_dataset("binaryalphadigits").__class__ is \
      pfuel.BinarizedAlphaDigits
  assert len(pfuel.BinarizedAlphaDigits().labels) == 36


def test_binarized_batches_match_jax(home):
  write(home, "MNIST", n_train=40)
  write(home, "BinarizedMNIST", n_train=40)
  for cls in ("BinarizedMNIST", "MNIST"):
    kw = dict(batch_size=8, epochs=1, shuffle=True, prefetch=0, seed=3)
    got = next(iter(getattr(pfuel, cls)().create_dataset("train", **kw)))
    want = next(iter(getattr(jfuel, cls)().create_dataset("train", **kw)))
    assert np.array_equal(np.asarray(got), np.asarray(want))
    if cls == "BinarizedMNIST":
      assert set(np.unique(np.asarray(got))) <= {0.0, 1.0}
      assert pfuel.BinarizedMNIST().binarized


def test_missing_file_raises(home):
  with pytest.raises(FileNotFoundError) as err:
    pfuel.CIFAR10()._load("train")
  with pytest.raises(FileNotFoundError) as jerr:
    jfuel.CIFAR10()._load("train")
  assert str(err.value) == str(jerr.value)
  assert "cifar10.npz" in str(err.value)


def test_registry_names_the_image_sets():
  jax_images = {c.__name__ for c in jfuel.get_all_dataset("image")}
  port = {c.__name__ for c in pfuel.get_all_dataset("image")}
  assert set(LOADERS) | {"HalfMoonsImage", "YDisentanglement"} <= port
  assert port <= jax_images
  # the text sets are ported too (tests/test_torch_nlp_loaders.py)
  assert type(pfuel.get_dataset("imdbreview")).__name__ == \
      type(jfuel.get_dataset("imdbreview")).__name__
  # the gene sets are ported (tests/test_torch_bio_data.py)
  assert type(pfuel.get_dataset("cortex")).__name__ == \
      type(jfuel.get_dataset("cortex")).__name__


def test_make_halfmoons_matches_jax():
  from odin_tpu.fuel.image_data.datasets import make_halfmoons as jmake
  from odin_tpu_torch.fuel.image_data.datasets import make_halfmoons
  for n, seed in ((1, 1), (2, 7)):
    x, y = make_halfmoons(n, seed=seed)
    jx, jy = jmake(n, seed=seed)
    same(x, jx)
    same(y, jy)
  assert x.shape == (80, 64, 64, 3) and x.max() > 0


def test_halfmoons_image_matches_jax():
  got, want = pfuel.HalfMoonsImage(1, seed=2), jfuel.HalfMoonsImage(1, seed=2)
  assert got.name == want.name and got.labels == want.labels
  g, w = partitions(got), partitions(want)
  for p in g:
    same(g[p][0], w[p][0])
    same(g[p][1], w[p][1])


@pytest.mark.parametrize("size", [28, 32])
def test_ydisentanglement_matches_jax(size):
  got = pfuel.YDisentanglement(n_samples=64, image_size=size, seed=3)
  want = jfuel.YDisentanglement(n_samples=64, image_size=size, seed=3)
  assert got.shape == tuple(want.shape) and got.labels == want.labels
  g, w = partitions(got), partitions(want)
  for p in g:
    same(g[p][0], w[p][0])
    same(g[p][1], w[p][1])
  assert pfuel.get_dataset("ydisentanglement", n_samples=8).n_samples == 8
