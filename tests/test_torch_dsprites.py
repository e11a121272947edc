"""The port's procedural dSprites against the JAX package's: both are the
same NumPy code, so the images and factors are equal exactly for the same
seed."""
import os

import numpy as np
import pytest

from odin_tpu.fuel import get_partition as jax_get_partition
from odin_tpu.fuel.image_data.datasets import dSprites as JaxdSprites
from odin_tpu_torch.fuel import dSprites, get_partition


@pytest.mark.parametrize("partition", ["train", "valid", "test"])
def test_procedural_dsprites_equal_jax(partition, tmp_path, monkeypatch):
  # no official dsprites.npz where the JAX package looks: its procedural
  # branch renders, as the port always does
  monkeypatch.setenv("ODIN_TPU_HOME", str(tmp_path))
  want = JaxdSprites(n_samples=600, seed=3)
  assert not os.path.exists(want.path)
  x_j, y_j = want.numpy(partition)
  x, y = dSprites(n_samples=600, seed=3).numpy(partition)
  assert x.shape == (600, 64, 64, 1) and x.dtype == np.float32
  assert y.shape == (600, 5) and y.dtype == np.float32
  np.testing.assert_array_equal(x, x_j)
  np.testing.assert_array_equal(y, y_j)
  assert set(np.unique(x)) <= {0.0, 1.0} and 0.01 < x.mean() < 0.3


def test_render_and_factors_equal_jax():
  rs = np.random.RandomState(0)
  ds, jds = dSprites(), JaxdSprites()
  f = ds._sample_factors(50, rs)
  np.testing.assert_array_equal(ds.render(f), jds.render(f))
  assert ds.shape == jds.shape == (64, 64, 1)
  assert ds.labels == jds.labels and ds.name == jds.name
  assert ds.numpy("train", n=7, inc_labels=False).shape == (7, 64, 64, 1)


def test_get_partition_equals_jax():
  for name in ("train", "valid", "val", "test"):
    assert get_partition(name, train=0, valid=1, test=2) == \
        jax_get_partition(name, train=0, valid=1, test=2)
  for bad in ("nope", "unlabeled"):
    with pytest.raises(ValueError):
      get_partition(bad, train=0, valid=1, test=2)
