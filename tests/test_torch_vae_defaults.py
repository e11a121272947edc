"""The VAE's default networks and M2's ``classify_on_features``, against
the JAX package.

``VariationalAutoencoder(input_shape=...)`` and ``Autoencoder(...)`` build
with JAX's defaults (``odin_tpu/bay/vi/autoencoder/
variational_autoencoder.py:134-146``): 32 'mvndiag' latents (a point mass
for the autoencoder), a Gaussian observation of the input's shape, and
two Dense(64, relu) layers each way.  Their flax trees have the paths and
shapes of JAX's own init, and their ELBO terms on the same weights (JAX's
draws injected) agree within rtol 1e-5 of each term's largest magnitude
(``tests/torch_zoo_common.py``), one training step too.  Every class of
the zoo that JAX constructs from ``input_shape`` alone the port
constructs, and builds wherever JAX's builds.  ``M2Core(...,
classify_on_features=True)`` classifies from the encoder's flattened
features, as JAX's does, within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odin_tpu.bay.vi as jax_vi
import odin_tpu_torch.bay.vi as port_vi
from odin_tpu.bay.vi.autoencoder.conditional_vae import M2Core as JaxM2Core
from odin_tpu_torch.bay.vi.autoencoder.conditional_vae import M2Core
from odin_tpu_torch.weights import to_jax_params
from torch_zoo_common import (assert_tree_matches_jax_init, binary_images,
                              elbo_matches_jax, make_pair, step_matches_jax,
                              tiny_networks)

torch.set_num_threads(2)
SHAPE = (8,)


def _gaussian_rows(n, seed):
  return np.random.RandomState(seed).randn(n, *SHAPE).astype(np.float32)


@pytest.mark.parametrize("cls", ["VariationalAutoencoder", "Autoencoder"])
def test_defaults_match_jax(cls):
  pair = make_pair(cls, networks={"input_shape": SHAPE},
                   jax_networks={"input_shape": SHAPE})
  jvae, vae = pair
  x = jnp.asarray(_gaussian_rows(2, 0))
  assert_tree_matches_jax_init(jvae, vae, x)
  layers = vae.core.encoder.layers
  assert [(type(l).__name__, l.units, l.activation) for l in layers] == [
      ("Dense", 64, "relu")] * 2
  assert vae.zdim == 32
  assert vae.core.observation.event_shape == SHAPE
  elbo_matches_jax(pair, _gaussian_rows(8, 1), steps=(0,))
  step_matches_jax(pair, _gaussian_rows(8, 2))


def _outcome(fn):
  try:
    fn()
    return True
  except Exception:  # noqa: BLE001 - any failure to build counts
    return False


@pytest.mark.parametrize("name", sorted(c.__name__
                                        for c in port_vi.get_vae(None)))
def test_builds_from_input_shape_wherever_jax_does(name):
  """Constructed from ``input_shape`` alone: where JAX's class constructs,
  the port's does; where the port's ``build`` fails, JAX's fails too."""
  jcls, pcls = jax_vi.get_vae(name), port_vi.get_vae(name)
  jax_made = _outcome(lambda: jcls(input_shape=SHAPE))
  try:
    vae = pcls(input_shape=SHAPE)
  except Exception:  # noqa: BLE001
    assert not jax_made, f"JAX's {name} constructs, the port's does not"
    return
  if not _outcome(lambda: vae.build(device="cpu")):
    assert not _outcome(lambda: jcls(input_shape=SHAPE).build()), \
        f"JAX's {name} builds, the port's does not"


def test_m2_classify_on_features_matches_jax():
  """The classifier reads the encoder's 32 features, not the 64 pixels."""
  from odin_tpu.bay.random_variable import RVconf as JRV
  from odin_tpu.networks.base import Dense as JDense
  from odin_tpu.networks.base import SequentialNetwork as JSeq
  from odin_tpu_torch.bay.random_variable import RVconf
  from odin_tpu_torch.networks import Dense, Flatten, SequentialNetwork

  nets, jnets = tiny_networks("torch"), tiny_networks("jax")
  head = lambda rv: rv(6, "onehot", projection=True, name="digits")
  core = M2Core(nets["encoder"], nets["decoder"],
                nets["latents"].create_posterior(name="latents"),
                nets["observation"].create_posterior(name="observation"),
                head(RVconf).create_posterior(name="labels"),
                SequentialNetwork((Dense(16, "relu"),)), embed_dim=8,
                n_classes=6, classify_on_features=True)
  core.build((8, 8, 1), torch.Generator().manual_seed(0))
  assert core.classifier.layers[0].weight.shape == (16, 32)
  jcore = JaxM2Core(
      encoder=jnets["encoder"], decoder=jnets["decoder"],
      latents=jnets["latents"].create_posterior(name="latents"),
      observation=jnets["observation"].create_posterior(name="observation"),
      labels=head(JRV).create_posterior(name="labels"),
      classifier=JSeq((JDense(16, "relu"),), name="classifier"),
      embed_dim=8, n_classes=6, classify_on_features=True)
  x = binary_images(4, 3)
  params = to_jax_params(core)
  want = jax.eval_shape(lambda: jcore.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x)))["params"]
  leaves = lambda t: {jax.tree_util.keystr(k): np.shape(v) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
  assert leaves(params) == leaves(want)
  jqy = jcore.apply({"params": params}, jnp.asarray(x), method="classify")
  with torch.no_grad():
    qy = core.classify(torch.from_numpy(x))
  w = np.asarray(jqy.mean())
  np.testing.assert_allclose(qy.mean().numpy(), w, rtol=0,
                             atol=1e-5 * float(np.abs(w).max()))
  # without the flag the classifier reads the image itself
  nets = tiny_networks("torch")
  plain = M2Core(nets["encoder"], nets["decoder"],
                 nets["latents"].create_posterior(name="latents"),
                 nets["observation"].create_posterior(name="observation"),
                 head(RVconf).create_posterior(name="labels"),
                 SequentialNetwork((Flatten(), Dense(16, "relu"))),
                 embed_dim=8, n_classes=6)
  plain.build((8, 8, 1), torch.Generator().manual_seed(0))
  assert plain.classifier.layers[1].weight.shape == (16, 64)
