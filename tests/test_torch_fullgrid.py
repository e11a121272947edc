"""The full factor grid and the dataset files of the port against the JAX
package on the CPU, under a temporary ``$ODIN_TPU_HOME``.

  * ``get_data_path``/``get_cache_path``/``get_exp_path`` give the JAX
    package's directories;
  * ``dSprites()`` reads ``<data path>/dsprites.npz`` where it exists, as
    the JAX package does (80/10/10 of its train split), and ``path=`` names
    another file;
  * ``FullGridMixin`` on subclasses of both packages' ``dSprites`` and
    ``Shapes3D`` with reduced ``factor_sizes``: ``grid_factors``, every
    partition's images and labels and the uint8 cache file bit for bit,
    each package reading the cache the other wrote; ``dSpritesSmall`` and
    ``dSprites0`` inherit the grid.
"""
import os

import numpy as np
import pytest

import odin_tpu.fuel.image_data.datasets as jax_ds
import odin_tpu.utils as jax_utils
import odin_tpu_torch.fuel.image_data.datasets as port_ds
from odin_tpu_torch import utils as port_utils

PARTITIONS = ("train", "valid", "test")


@pytest.fixture
def home(tmp_path, monkeypatch):
  monkeypatch.setenv("ODIN_TPU_HOME", str(tmp_path / "home"))
  return tmp_path / "home"


def _same(port, jax_obj):
  for p in PARTITIONS:
    x, y = port._load(p)
    jx, jy = jax_obj._load(p)
    np.testing.assert_array_equal(x, jx, err_msg=p)
    np.testing.assert_array_equal(y, jy, err_msg=p)
    assert x.dtype == jx.dtype and y.dtype == jy.dtype, p


def test_managed_paths_equal_jax(home):
  for name in ("get_data_path", "get_cache_path", "get_exp_path"):
    got = getattr(port_utils, name)()
    assert got == getattr(jax_utils, name)()
    assert got.startswith(str(home)) and os.path.isdir(got)


def _write_dsprites(path, n=50, seed=0):
  rs = np.random.RandomState(seed)
  x = (rs.rand(n, 64, 64, 1) < 0.3).astype(np.uint8)
  y = np.stack([rs.randint(0, k, n) for k in (3, 6, 40, 32, 32)], -1)
  os.makedirs(os.path.dirname(path), exist_ok=True)
  np.savez(path, x_train=x, y_train=y.astype(np.int64))
  return x, y


@pytest.mark.parametrize("cls", ["dSprites", "dSpritesSmall", "dSprites0"])
def test_default_dsprites_file_is_read(home, cls):
  """With ``<data path>/dsprites.npz`` on disk, both packages return its
  80/10/10 split (the port rendered its own images before)."""
  x, y = _write_dsprites(os.path.join(home, "datasets", "dsprites.npz"))
  port, jobj = getattr(port_ds, cls)(), getattr(jax_ds, cls)()
  _same(port, jobj)
  if cls == "dSprites":
    xt, yt = port._load("valid")
    np.testing.assert_array_equal(xt, x[40:45])
    np.testing.assert_array_equal(yt, y[40:45].astype(np.float32))


def test_explicit_dsprites_path(home, tmp_path):
  path = str(tmp_path / "mine" / "sprites.npz")
  _write_dsprites(path, n=30, seed=4)
  _same(port_ds.dSprites(path=path), jax_ds.dSprites(path=path))
  # without the file the path changes nothing: both render
  missing = str(tmp_path / "absent.npz")
  _same(port_ds.dSprites(n_samples=16, path=missing),
        jax_ds.dSprites(n_samples=16, path=missing))


def _grid_classes(base, sizes):
  return (type("Port" + base, (getattr(port_ds, base),),
               {"factor_sizes": list(sizes)}),
          type("Jax" + base, (getattr(jax_ds, base),),
               {"factor_sizes": list(sizes)}))


GRIDS = [("dSprites", (2, 2, 3, 2, 2), {}),
         ("dSprites0", (3, 2, 2, 2, 2), dict(all_labels=True)),
         ("dSpritesSmall", (2, 1, 4, 2, 3), dict(seed=5)),
         ("Shapes3D", (2, 2, 3, 2, 2, 2), {}),
         ("Shapes3D0", (2, 1, 4, 2, 1, 3), dict(seed=3))]


@pytest.mark.parametrize("base,sizes,kwargs", GRIDS)
def test_full_grid_equals_jax(home, monkeypatch, tmp_path, base, sizes,
                              kwargs):
  port_cls, jax_cls = _grid_classes(base, sizes)
  port = port_cls(full_grid=True, **kwargs)
  jobj = jax_cls(full_grid=True, **kwargs)
  np.testing.assert_array_equal(port.grid_factors(), jobj.grid_factors())
  assert port.grid_factors().dtype == np.int64
  assert len(port.grid_factors()) == int(np.prod(sizes))
  # each package writes its cache under its own home
  monkeypatch.setenv("ODIN_TPU_HOME", str(tmp_path / "port"))
  x_port = [port._load(p) for p in PARTITIONS]
  port_cache = port._grid_cache_path()
  monkeypatch.setenv("ODIN_TPU_HOME", str(tmp_path / "jax"))
  x_jax = [jobj._load(p) for p in PARTITIONS]
  jax_cache = jobj._grid_cache_path()
  assert os.path.basename(port_cache) == os.path.basename(jax_cache) == \
      f"{port.name}_fullgrid_u8_64.npy"
  assert not os.path.exists(port_cache + ".tmp")
  with open(port_cache, "rb") as f, open(jax_cache, "rb") as g:
    assert f.read() == g.read()
  total = 0
  for p, (x, y), (jx, jy) in zip(PARTITIONS, x_port, x_jax):
    np.testing.assert_array_equal(x, jx, err_msg=p)
    np.testing.assert_array_equal(y, jy, err_msg=p)
    assert x.dtype == np.uint8 and y.dtype == jy.dtype
    total += len(x)
  assert total == int(np.prod(sizes))
  # each reads the other's cache: a fresh object of the port under JAX's
  # home memory-maps JAX's file and serves the same partitions
  again = port_cls(full_grid=True, **kwargs)
  for p, (jx, jy) in zip(PARTITIONS, x_jax):
    x, y = again._load(p)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


def test_full_grid_cache_holds_the_rendered_grid(home):
  port_cls, _ = _grid_classes("Shapes3D", (1, 2, 3, 1, 2, 1))
  ds = port_cls(full_grid=True)
  ds._load("train")
  cache = np.load(ds._grid_cache_path())
  want = (ds.render(ds.grid_factors()) * 255).astype(np.uint8)
  np.testing.assert_array_equal(cache, want)
