"""The port's input pipeline and datasets against the JAX package's on
the CPU: ``DataPipeline`` and ``ImageDataset.create_dataset`` give the same
batches, bit for bit, on the same seed and data (both gather with numpy
indexing semantics and shuffle with ``numpy.random.RandomState``)."""
import numpy as np
import pytest
import torch

from odin_tpu.fuel import DataPipeline as JaxDataPipeline
from odin_tpu.fuel.image_data.datasets import dSprites as JaxdSprites
from odin_tpu.fuel.image_data.datasets import dSprites0 as JaxdSprites0
from odin_tpu_torch.fuel import (DataPipeline, dSprites, dSprites0,
                                 dSpritesSmall, get_all_dataset, get_dataset)


def _leaves(batch):
  if isinstance(batch, dict):
    return [v for k in sorted(batch) for v in _leaves(batch[k])]
  if isinstance(batch, (tuple, list)):
    return [v for b in batch for v in _leaves(b)]
  return [np.asarray(batch)]


def _assert_same_batches(got, want, n):
  got, want = iter(got), iter(want)
  for i in range(n):
    g, w = _leaves(next(got)), _leaves(next(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
      assert a.dtype == b.dtype and a.shape == b.shape, i
      np.testing.assert_array_equal(a, b, err_msg=f"batch {i}")


ARRAYS = {
    "array": lambda rs: rs.randn(23, 3).astype(np.float32),
    "tuple": lambda rs: (rs.randn(23, 2, 2).astype(np.float32),
                         rs.randint(0, 5, 23)),
    "dict": lambda rs: {"x": rs.rand(23, 4).astype(np.float32),
                        "y": rs.randint(0, 3, 23)},
}


@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("kind", sorted(ARRAYS))
def test_data_pipeline_matches_jax(kind, shuffle, drop_remainder):
  """Three epochs of batches of 5 over 23 examples (a partial batch each
  epoch unless dropped), with a map, prefetched on a thread."""
  arrays = ARRAYS[kind](np.random.RandomState(3))
  kw = dict(batch_size=5, shuffle=shuffle, epochs=3,
            drop_remainder=drop_remainder, seed=7, prefetch=2)
  mapped = lambda b: b if kind != "array" else b * 2
  got = DataPipeline(arrays, **kw).map(mapped)
  want = JaxDataPipeline(arrays, **kw).map(mapped)
  assert len(got) == len(want) and got.steps_per_epoch == want.steps_per_epoch
  _assert_same_batches(got, want, len(want))
  assert len(list(got)) == len(want)


def test_data_pipeline_repeat_and_take():
  x = np.arange(10, dtype=np.float32)
  got = DataPipeline(x, batch_size=4, shuffle=True, seed=2,
                     prefetch=0).repeat(-1)
  want = JaxDataPipeline(x, batch_size=4, shuffle=True, seed=2,
                         prefetch=0).repeat(-1)
  _assert_same_batches(got.take(7), want.take(7), 7)


def test_data_pipeline_to_device_cpu_and_errors():
  """A device gives torch tensors there; a worker's error reaches the
  consumer; the card without one raises at construction."""
  x = np.arange(12, dtype=np.float32).reshape(6, 2)
  out = list(DataPipeline((x, x), batch_size=4, to_device="cpu"))
  assert all(isinstance(t, torch.Tensor) for b in out for t in b)
  np.testing.assert_array_equal(out[1][0].numpy(), x[4:])

  def boom(b):
    raise KeyError("bad batch")

  with pytest.raises(KeyError, match="bad batch"):
    list(DataPipeline(x, batch_size=2, map_fn=boom))
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
      DataPipeline(x, to_device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
      dSpritesSmall(n_samples=8).create_dataset(to_device="cuda")


CREATE = {
    "unsupervised": dict(),
    "unsupervised_tanh": dict(normalize="tanh", shuffle=False),
    "unsupervised_raster_drop": dict(normalize="raster", drop_remainder=True,
                                     binarize=False),
    "labelled": dict(label_percent=True),
    "semi_fraction": dict(label_percent=0.1, oversample_ratio=0.25),
    "semi_count": dict(label_percent=9, oversample_ratio=0.5,
                       shuffle=False),
    "semi_tanh": dict(label_percent=0.2, normalize="tanh"),
}


@pytest.mark.parametrize("case", sorted(CREATE))
@pytest.mark.parametrize("cls", ["dsprites", "dsprites0"])
def test_create_dataset_matches_jax(cls, case):
  """Every branch of ``create_dataset`` on dSprites (five float factor
  labels) and dSprites0 (one-hot shape labels): two epochs of batches,
  bitwise."""
  port, jax_cls = {"dsprites": (dSprites, JaxdSprites),
                   "dsprites0": (dSprites0, JaxdSprites0)}[cls]
  ds, jds = port(n_samples=90, seed=4), jax_cls(n_samples=90, seed=4)
  kw = dict(batch_size=16, epochs=2, seed=3, **CREATE[case])
  got = ds.create_dataset("valid", **kw)
  want = jds.create_dataset("valid", **kw)
  n = sum(1 for _ in jds.create_dataset("valid", **kw))
  assert n > 0
  assert getattr(got, "steps_per_epoch") == getattr(want, "steps_per_epoch")
  _assert_same_batches(got, want, n)


def test_dataset_api_matches_jax():
  ds, jds = dSprites0(n_samples=40, seed=2), JaxdSprites0(n_samples=40,
                                                          seed=2)
  assert ds.name == jds.name and ds.labels == jds.labels
  assert ds.n_labels == jds.n_labels and ds.full_shape == jds.full_shape
  assert ds.data_type == jds.data_type == "image"
  np.testing.assert_array_equal(ds.sample_images(5, seed=3),
                                jds.sample_images(5, seed=3))
  for inc in (False, True):
    _assert_same_batches([ds.numpy("test", n=7, inc_labels=inc)],
                         [jds.numpy("test", n=7, inc_labels=inc)], 1)


def test_get_dataset_lists_only_what_is_ported():
  assert isinstance(get_dataset("dsprites"), dSprites)
  assert isinstance(get_dataset("dSprites_Small", n_samples=8), dSpritesSmall)
  assert [c.__name__ for c in get_all_dataset("image")] == \
      ["BinarizedAlphaDigits", "BinarizedMNIST", "CIFAR10", "CIFAR100",
       "CIFAR20", "CelebA", "CelebABig", "CelebASmall", "FashionMNIST",
       "HalfMNIST", "HalfMoons", "HalfMoonsImage", "Kaokore", "LegoFaces",
       "MNIST", "Omniglot", "SVHN", "Shapes3D", "Shapes3D0",
       "Shapes3DSmall", "YDisentanglement", "dSprites", "dSprites0",
       "dSpritesSmall"]
  assert [c.__name__ for c in get_all_dataset()] == sorted(
      [c.__name__ for c in get_all_dataset("image")] +
      ["BreastTumor", "Cortex", "Forebrain", "HumanEmbryos", "Insilico",
       "Leukemia", "Melanoma", "PBMC", "SyntheticATAC", "SyntheticGenes",
       "ImdbReview", "MathArithmetic", "Newsgroup20", "Newsgroup20_clean",
       "Newsgroup5", "SyntheticBoW", "TinyShakespear"])
  assert type(get_dataset("cortex")).__name__ == "Cortex"
  assert type(get_dataset("imdbreview")).__name__ == "ImdbReview"
  with pytest.raises(ValueError, match="cannot find dataset 'nope'"):
    get_dataset("nope")
  assert dSprites(full_grid=True).full_grid


def test_prefetch_thread_keeps_order_and_ends():
  """Under a short thread switch interval, with several pipelines read at
  once by more threads than cores: every pipeline yields its batches in
  order, and a consumer that stops early ends its worker thread."""
  import sys
  import threading
  x = np.arange(400, dtype=np.float32).reshape(200, 2)
  want = [b.copy() for b in DataPipeline(x, batch_size=7, shuffle=True,
                                         epochs=2, seed=9, prefetch=0)]
  errors, interval = [], sys.getswitchinterval()
  base = threading.active_count()

  def read(stop_after):
    try:
      got = []
      for b in DataPipeline(x, batch_size=7, shuffle=True, epochs=2, seed=9,
                            prefetch=1):
        got.append(b)
        if len(got) == stop_after:
          break
      n = len(got)
      assert all(np.array_equal(g, w) for g, w in zip(got, want[:n]))
    except AssertionError as e:
      errors.append(e)

  sys.setswitchinterval(1e-6)
  try:
    readers = [threading.Thread(target=read, args=(n,))
               for n in (3, 10_000) * 6]
    for t in readers:
      t.start()
    for t in readers:
      t.join(timeout=60)
  finally:
    sys.setswitchinterval(interval)
  assert not any(t.is_alive() for t in readers)
  assert not errors, errors[0]
  assert threading.active_count() == base
