"""The weight bridge of the hierarchical and grouped families: the port's
params of each new class as a flax tree (``to_jax_params``) have exactly
the paths and shapes of the tree the JAX package's ``build()`` would
initialise (flax's init traced for its shapes alone), on the full-width
dSprites networks with JAX's ``hierarchy`` spec (each rung kind of the
ladder), and ``from_jax_params`` carries the tree back to the same
tensors, bit for bit."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odin_tpu.bay.vi as jax_vi
import odin_tpu_torch.bay.vi as port_vi
from odin_tpu.networks import get_networks as jax_networks
from odin_tpu_torch.networks import get_networks as port_networks
from odin_tpu_torch.weights import from_jax_params, to_jax_params

CASES = {
    "HierarchicalVAE": {}, "LadderVAE-parallel": dict(latents="parallel"),
    "HierarchicalVAE-bidense": dict(latents="bidense"), "UnetVAE": {},
    "PUnetVAE": {}, "VeryDeepVAE": {}, "GroupVAE": {}, "MultiLevelVAE": {},
    "AdaptiveVAE": {}, "WeaklySupervisedVAE": {},
}


def _shapes(tree, prefix=()):
  for k, v in tree.items():
    if isinstance(v, dict):
      yield from _shapes(v, prefix + (k,))
    else:
      yield "/".join(prefix + (k,)), tuple(np.shape(v))


def _networks(get, latents):
  nets = get("dsprites", zdim=10)
  if latents is not None:
    nets["hierarchy"] = tuple(dict(h, latents=latents)
                              for h in nets["hierarchy"])
  return nets


def test_dsprites_networks_carry_jaxs_hierarchy():
  assert port_networks("dsprites")["hierarchy"] == \
      jax_networks("dsprites")["hierarchy"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_ports_tree_is_flaxs_both_ways(case):
  name = case.split("-")[0]
  latents = CASES[case].get("latents")
  vae = getattr(port_vi, name)(**_networks(port_networks, latents)).build(
      device="cpu")
  jvae = getattr(jax_vi, name)(**_networks(jax_networks, latents))
  key = jax.random.PRNGKey(0)
  x = jnp.zeros((1,) + tuple(vae.input_shape), jnp.float32)
  want = jax.eval_shape(lambda: jvae.core.init(
      {"params": key, "dropout": key, "sample": key}, x))["params"]
  tree = to_jax_params(vae.core)
  assert dict(_shapes(tree)) == dict(_shapes(want))
  back = from_jax_params(tree)
  params = vae.state.params["vae"]
  assert set(back) == set(params)
  for k, v in params.items():
    assert torch.equal(back[k], v), k
