"""The weight bridge on the layers of ``networks/time_delay.py``,
``util_layers.py`` and ``dropout.py``, from the JAX side: each JAX
layer's own init (its values, not only its shapes) carried into the
port's layer by ``from_jax_params``/``from_jax_mutables`` and back by
``to_jax_params``/``to_jax_mutables``, bit for bit; and the names the
port's ``networks`` package exports against the JAX package's.
"""
import ast
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import odin_tpu.networks.base as JB
import odin_tpu.networks.time_delay as JT
import odin_tpu.networks.util_layers as JU
import odin_tpu_torch.networks as PN
import odin_tpu_torch.networks.base as PB
import odin_tpu_torch.networks.time_delay as PT
import odin_tpu_torch.networks.util_layers as PU
from odin_tpu_torch.weights import (from_jax_mutables, from_jax_params,
                                    to_jax_mutables, to_jax_params)

ROOT = pathlib.Path(__file__).resolve().parent.parent

# name: (make(time_delay, util_layers, base), input shape without the batch)
LAYERS = {
    "time_delay": (lambda t, u, b: t.TimeDelay(4), (9, 3)),
    "time_delay_irregular": (lambda t, u, b: t.TimeDelay(4, (-1, 0, 2)),
                             (9, 3)),
    "time_delay_dense": (lambda t, u, b: t.TimeDelayDense(5), (9, 3)),
    "time_delay_conv": (lambda t, u, b: t.TimeDelayConv(4, 3, 2), (9, 3)),
    "time_delay_tied": (lambda t, u, b: t.TimeDelayConvTied(4), (9, 3)),
    "xvector": (lambda t, u, b: t.XVectorNet(5, 16), (12, 4)),
    "conv1d_transpose": (lambda t, u, b: u.Conv1DTranspose(3, 3, 2),
                         (5, 2)),
    "renorm": (lambda t, u, b: u.BatchRenormalization(), (6,)),
    "parallel": (lambda t, u, b: u.ParallelNetwork((b.Dense(2), b.Dense(3))),
                 (4,)),
    "skip": (lambda t, u, b: u.SkipConnection(b.Dense(5)), (4,)),
    "lstm": (lambda t, u, b: u.LSTM(3), (5, 2)),
    "gru": (lambda t, u, b: u.GRU(3), (5, 2)),
    "rnn": (lambda t, u, b: u.SimpleRNN(3), (5, 2)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_jax_init_round_trips(name):
  make, shape = LAYERS[name]
  x = jnp.asarray(np.random.RandomState(0).randn(2, *shape), jnp.float32)
  variables = jax.device_get(make(JT, JU, JB).init(jax.random.PRNGKey(3),
                                                    x))
  params = variables["params"]
  mutables = {k: v for k, v in variables.items() if k != "params"}
  port = make(PT, PU, PB)
  port.build(shape)
  sd = from_jax_params(params)
  sd.update(from_jax_mutables(mutables))
  port.load_state_dict(sd, strict=True)
  back = to_jax_params(port)
  flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
  got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
  assert set(got) == set(flat)
  for k, v in flat.items():
    assert np.array_equal(got[k], np.asarray(v)), jax.tree_util.keystr(k)
  flat_m = dict(jax.tree_util.tree_flatten_with_path(mutables)[0])
  got_m = dict(jax.tree_util.tree_flatten_with_path(to_jax_mutables(port))[0])
  assert set(got_m) == set(flat_m)
  for k, v in flat_m.items():
    assert np.array_equal(got_m[k], np.asarray(v)), jax.tree_util.keystr(k)


def test_embedding_and_projection_round_trip():
  """``ConditionalEmbedding``'s ``embedding/embedding`` and the bare
  Denses of ``ConditionalProjection`` ('film')."""
  y = jnp.asarray(np.eye(4, dtype=np.float32)[:2])
  x = jnp.ones((2, 3, 5))
  for jmod, port, args, build in (
      (JU.ConditionalEmbedding(4, 6), PU.ConditionalEmbedding(4, 6), (y,),
       lambda p: p.build((4,))),
      (JU.ConditionalProjection(3, "film"), PU.ConditionalProjection(
          3, "film"), (x, y), lambda p: p.build((3, 5), None, (4,)))):
    params = jax.device_get(jmod.init(jax.random.PRNGKey(1), *args))["params"]
    build(port)
    port.load_state_dict(from_jax_params(params), strict=True)
    back = to_jax_params(port)
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == set(flat)
    for k, v in flat.items():
      assert np.array_equal(got[k], np.asarray(v))


def _exported(path):
  """The names a package's ``__init__.py`` imports from its modules."""
  names = set()
  for node in ast.parse(path.read_text()).body:
    if isinstance(node, ast.ImportFrom):
      names |= {a.asname or a.name for a in node.names}
  return names


# what the port's package exports beyond JAX's: helpers that the JAX
# package keeps in its modules (the per-dataset networks, the attention
# heads, GRUCell, SkipSequential, the image-parameter packing)
PORT_EXTRAS = {
    "AttentionHeads", "create_attention_heads", "GRUCell", "SkipSequential",
    "PackImageParams", "ResidualUpBlock", "SigmoidGating",
    "binarizedmnist_networks", "celeba_networks", "cifar10_networks",
    "cifar20_networks", "cifar100_networks", "cifar_networks",
    "cortex_networks", "dsprites_networks", "fashionmnist_networks",
    "halfmnist_networks", "halfmoons_networks", "locatello_networks",
    "mnist_networks", "omniglot_networks", "pbmc_networks",
    "shapes3d_networks", "svhn_networks", "vq_dsprites_networks"}


def test_networks_exports_equal_jax():
  """Every name JAX's ``networks/__init__.py`` exports, the port's exports
  too, and the port's other names are exactly its listed extras."""
  jax_names = _exported(ROOT / "odin_tpu" / "networks" / "__init__.py")
  port_names = _exported(ROOT / "odin_tpu_torch" / "networks" /
                         "__init__.py")
  assert port_names - PORT_EXTRAS == jax_names
  for name in jax_names:
    assert getattr(PN, name) is not None, name
  for name in ("TimeDelay", "XVectorNet", "LSTM", "Resampling2D",
               "DiscreteDropout", "DropBlock", "Embedder", "all_embedder"):
    assert name in jax_names
