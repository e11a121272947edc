"""The label embedders of the port against the JAX package's
(``networks/conditional_embedding.py``) on int, one-hot and soft labels,
from the same params; the projection's gradient to soft labels; and the
weight bridge over every module of the semi-supervised family: the port's
params as a flax tree and back, bitwise, for each of the 19 classes."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from odin_tpu.networks import conditional_embedding as jemb
from odin_tpu_torch.networks import conditional_embedding as pemb
from odin_tpu_torch.weights import from_jax_params, to_jax_params
from torch_semi_common import SEMI, semi_networks

K, E = 4, (3, 2)


def _labels(kind):
  rs = np.random.RandomState(0)
  idx = rs.randint(0, K, 6)
  if kind == "int":
    return idx.astype(np.int32)
  if kind == "onehot":
    return np.eye(K, dtype=np.float32)[idx]
  soft = rs.rand(6, K).astype(np.float32)
  return soft / soft.sum(-1, keepdims=True)


@pytest.mark.parametrize("kind", ["int", "onehot", "soft"])
@pytest.mark.parametrize("method", ["identity", "dictionary", "projection",
                                    "sequential"])
def test_embedders_match_jax(method, kind):
  y = _labels(kind)
  jm = jemb.get_embedding(method)(n_classes=K, event_shape=E)
  variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(y))
  want = np.asarray(jm.apply(variables, jnp.asarray(y)))
  pm = pemb.get_embedding(method)(K, E)
  pm.build((K,), torch.Generator().manual_seed(0))
  if variables:
    pm.load_state_dict(from_jax_params(variables["params"]))
    for k, v in to_jax_params(pm).items():  # and back, bitwise
      for leaf, a in v.items():
        np.testing.assert_array_equal(
            a, np.asarray(variables["params"][k][leaf]))
  got = pm(torch.from_numpy(y)).detach().numpy()
  np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["int", "onehot"])
def test_repetition_matches_jax(kind):
  y = _labels(kind)
  shape = (5, 7, K) if kind == "onehot" else (5, 1)
  want = jemb.RepetitionEmbedding(n_classes=K, event_shape=shape).apply(
      {}, jnp.asarray(y))
  got = pemb.RepetitionEmbedding(K, shape)(torch.from_numpy(y))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_projection_keeps_soft_label_gradients():
  y = torch.from_numpy(_labels("soft")).requires_grad_(True)
  proj = pemb.ProjectionEmbedding(K, (5,))
  proj.build((K,), torch.Generator().manual_seed(0))
  proj(y).sum().backward()
  assert y.grad is not None and float(y.grad.abs().sum()) > 0
  lookup = pemb.SequentialEmbedding(K, (5,))
  lookup.build((K,), torch.Generator().manual_seed(0))
  y2 = torch.from_numpy(_labels("soft")).requires_grad_(True)
  lookup(y2).sum().backward()  # the lookup folds by argmax: no gradient
  assert y2.grad is None


def test_get_embedding_takes_a_prefix():
  assert pemb.get_embedding("proj") is pemb.ProjectionEmbedding
  assert pemb.get_embedding("Sequential") is pemb.SequentialEmbedding
  assert sorted(pemb.all_embedder) == sorted(jemb.all_embedder)
  with pytest.raises(KeyError):
    pemb.get_embedding("nope")


@pytest.mark.parametrize("name", SEMI)
def test_the_bridge_round_trips_every_module(name):
  """The port's params of every partition as a flax tree and back: the
  same names, the same bits."""
  import odin_tpu_torch.bay.vi as vi
  vae = getattr(vi, name)(**semi_networks(name, "torch")).build(
      seed=3, device="cpu")
  modules = {"vae": vae.core, **vae.extras}
  for part, module in modules.items():
    params = vae.state.params[part]
    back = from_jax_params(to_jax_params(module, params))
    assert set(back) == set(params), part
    for k, v in params.items():
      assert torch.equal(back[k], v), (part, k)
