"""Shapes3D and the Locatello trunk of the port against the JAX package on
the CPU.

  * ``Shapes3D``, ``Shapes3DSmall`` and ``Shapes3D0`` (shape-only and
    ``all_labels`` one-hots) draw and render the JAX package's images and
    labels bit for bit in every partition, at reduced ``n_samples``;
  * the ``.npz`` branch: every partition is the file's ``x_train`` /
    ``y_train`` in both packages (a file the test writes);
  * ``get_dataset`` finds the three classes;
  * ``shapes3d_networks`` and ``locatello_networks`` (n_channels 1 and 3):
    the port's params as a flax tree (``to_jax_params``) have the paths and
    shapes flax's init gives (traced for shapes alone) and come back bit
    for bit; encode and decode within 1e-5 of flax on those weights.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odin_tpu.fuel.image_data.datasets as jax_ds
import odin_tpu.bay.vi as jax_vi
import odin_tpu_torch.bay.vi as port_vi
import odin_tpu_torch.fuel.image_data.datasets as port_ds
from odin_tpu.networks import get_networks as jax_networks
from odin_tpu.training.core import TrainState as JaxTrainState
from odin_tpu_torch.fuel import get_dataset
from odin_tpu_torch.networks import get_networks as port_networks
from odin_tpu_torch.weights import from_jax_params, to_jax_params

torch.set_num_threads(2)

NET_ATOL = 1e-5
PARTITIONS = ("train", "valid", "test")


@pytest.fixture
def home(tmp_path, monkeypatch):
  monkeypatch.setenv("ODIN_TPU_HOME", str(tmp_path))
  return tmp_path


def _same(port, jax_obj, partitions=PARTITIONS):
  for p in partitions:
    x, y = port._load(p)
    jx, jy = jax_obj._load(p)
    np.testing.assert_array_equal(x, jx, err_msg=p)
    np.testing.assert_array_equal(y, jy, err_msg=p)
    assert x.dtype == jx.dtype and y.dtype == jy.dtype


@pytest.mark.parametrize("cls,kwargs", [
    ("Shapes3D", dict(n_samples=96, seed=3)),
    ("Shapes3DSmall", dict(n_samples=64)),
    ("Shapes3D0", dict(n_samples=80, seed=2)),
    ("Shapes3D0", dict(n_samples=80, all_labels=True)),
])
def test_draws_equal_jax(home, cls, kwargs):
  port = getattr(port_ds, cls)(**kwargs)
  jobj = getattr(jax_ds, cls)(**kwargs)
  assert port.name == jobj.name
  assert port.shape == jobj.shape == (64, 64, 3)
  assert port.labels == jobj.labels
  _same(port, jobj)
  x, y = port._load("train")
  assert x.shape == (kwargs["n_samples"], 64, 64, 3)
  assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
  if cls == "Shapes3D0":
    assert y.shape[1] == (57 if kwargs.get("all_labels") else 4)
    np.testing.assert_array_equal(y.sum(-1), 6 if kwargs.get("all_labels")
                                  else 1)


def test_render_and_hue_equal_jax():
  rs = np.random.RandomState(5)
  f = np.stack([rs.randint(0, k, 40) for k in port_ds.Shapes3D.factor_sizes],
               -1)
  np.testing.assert_array_equal(port_ds.Shapes3D().render(f),
                                jax_ds.Shapes3D().render(f))
  h = np.linspace(0, 1, 23)
  np.testing.assert_array_equal(port_ds.Shapes3D._hue_to_rgb(h),
                                jax_ds.Shapes3D._hue_to_rgb(h))


def test_npz_branch_returns_the_train_split_everywhere(home):
  """JAX's quirk, kept: every partition of a ``shapes3d.npz`` is its
  train split, with no 80/10/10 cut (ROADMAP queue 3)."""
  rs = np.random.RandomState(0)
  x = rs.randint(0, 256, (10, 64, 64, 3)).astype(np.uint8)
  y = rs.randint(0, 4, (10, 6)).astype(np.float32)
  path = os.path.join(home, "datasets", "shapes3d.npz")
  os.makedirs(os.path.dirname(path), exist_ok=True)
  np.savez(path, x_train=x, y_train=y)
  for cls in ("Shapes3D", "Shapes3D0"):
    port, jobj = getattr(port_ds, cls)(), getattr(jax_ds, cls)()
    _same(port, jobj)
  xs, ys = port_ds.Shapes3D()._load("test")
  np.testing.assert_array_equal(xs, x)
  np.testing.assert_array_equal(ys, y)
  # an explicit path is read too
  other = os.path.join(home, "other.npz")
  np.savez(other, x_train=x[:3], y_train=y[:3])
  _same(port_ds.Shapes3D(path=other), jax_ds.Shapes3D(path=other))


def test_get_dataset_finds_shapes3d():
  for name, cls in (("shapes3d", port_ds.Shapes3D),
                    ("shapes3dsmall", port_ds.Shapes3DSmall),
                    ("Shapes3D0", port_ds.Shapes3D0)):
    ds = get_dataset(name, n_samples=8)
    assert type(ds) is cls and ds.n_samples == 8


def _shapes(tree, prefix=()):
  for k, v in tree.items():
    if isinstance(v, dict):
      yield from _shapes(v, prefix + (k,))
    else:
      yield "/".join(prefix + (k,)), tuple(np.shape(v))


NETS = [("shapes3d", {}), ("shapes3dsmall", {}), ("shapes3d0", {}),
        ("locatello", {}), ("locatello", dict(n_channels=3))]


@pytest.mark.parametrize("name,kwargs", NETS)
def test_network_tree_is_flaxs(name, kwargs):
  vae = port_vi.BetaVAE(**port_networks(name, **kwargs)).build(
      seed=2, device="cpu")
  jvae = jax_vi.BetaVAE(**jax_networks(name, **kwargs))
  key = jax.random.PRNGKey(0)
  x = jnp.zeros((1,) + tuple(vae.input_shape), jnp.float32)
  want = jax.eval_shape(lambda: jvae.core.init(
      {"params": key, "sample": key}, x))["params"]
  tree = to_jax_params(vae.core)
  assert dict(_shapes(tree)) == dict(_shapes(want))
  back = from_jax_params(tree)
  for k, v in vae.core.state_dict().items():
    assert torch.equal(back[k], v), k


def test_network_specs_equal_jax():
  for name, kwargs in NETS:
    port, jnets = port_networks(name, **kwargs), jax_networks(name, **kwargs)
    assert tuple(port["input_shape"]) == tuple(jnets["input_shape"])
    assert port["hierarchy"] == jnets["hierarchy"]
  assert port_networks("locatello")["hierarchy"] == ()
  semi = port_networks("shapes3d", is_semi_supervised=True)["labels"]
  jsemi = jax_networks("shapes3d", is_semi_supervised=True)["labels"]
  assert semi.event_shape == jsemi.event_shape == (6,)


@pytest.mark.parametrize("name,kwargs", [("shapes3d", {}),
                                         ("locatello", dict(n_channels=3)),
                                         ("locatello", {})])
def test_forward_matches_flax(name, kwargs):
  vae = port_vi.BetaVAE(**port_networks(name, **kwargs)).build(
      seed=4, device="cpu")
  jvae = jax_vi.BetaVAE(**jax_networks(name, **kwargs))
  jvae.input_shape = vae.input_shape
  jvae.state = JaxTrainState(
      params={"vae": to_jax_params(vae.core)}, opt_states={},
      step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(5), mutables={})
  rs = np.random.RandomState(7)
  x = rs.rand(3, *vae.input_shape).astype(np.float32)
  z = rs.randn(3, 10).astype(np.float32)
  qz, jqz = vae.encode(x), jvae.encode(x, jit=False)
  np.testing.assert_allclose(qz.mean().detach().numpy(),
                             np.asarray(jqz.mean()), atol=NET_ATOL)
  np.testing.assert_allclose(qz.stddev().detach().numpy(),
                             np.asarray(jqz.stddev()), atol=NET_ATOL)
  px, jpx = vae.decode(z), jvae.decode(z, jit=False)
  np.testing.assert_allclose(px.mean().detach().numpy(),
                             np.asarray(jpx.mean()), atol=NET_ATOL)
