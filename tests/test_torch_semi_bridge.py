"""The port's params of each new core as a flax tree (``to_jax_params``)
have exactly the paths and shapes of the tree the JAX package's own
``build()`` initialises, so that both packages start every test from the
same state (flax's initialisation traced for its shapes alone, as
``build()`` runs it), for each of the 19 classes: M2's core with either
label embedder, M3's, ADGM's, the dual-latent core of semafod and semafoh,
the conditional decoders of the semafos variants, the labels head on a
VAE's core, and the Semi-Factor pair's wider discriminator."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import odin_tpu.bay.vi as jax_vi
import odin_tpu_torch.bay.vi as port_vi
from odin_tpu_torch.weights import to_jax_params
from torch_semi_common import SEMI, semi_networks


def _shapes(tree, prefix=()):
  for k, v in tree.items():
    if isinstance(v, dict):
      yield from _shapes(v, prefix + (k,))
    else:
      yield "/".join(prefix + (k,)), tuple(np.shape(v))


@pytest.mark.parametrize("name", SEMI)
def test_the_ports_tree_is_flaxs(name):
  vae = getattr(port_vi, name)(**semi_networks(name, "torch")).build(
      device="cpu")
  jvae = getattr(jax_vi, name)(**semi_networks(name, "jax"))
  key = jax.random.PRNGKey(0)
  x = jnp.zeros((1,) + tuple(vae.input_shape), jnp.float32)
  params = {"vae": jax.eval_shape(lambda: jvae.core.init(
      {"params": key, "dropout": key, "sample": key}, x))["params"]}
  for part, (module, dummy) in jvae.extra_networks().items():
    params[part] = jax.eval_shape(lambda: module.init(
        {"params": key, "dropout": key}, dummy()))["params"]
  mine = {"vae": to_jax_params(vae.core)}
  for part, module in vae.extras.items():
    mine[part] = to_jax_params(module, vae.state.params[part])
  want = dict(_shapes(params))
  assert dict(_shapes(mine)) == want
