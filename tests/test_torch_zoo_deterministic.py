"""The port's irmVAE, irmAE and DistEncoder against the JAX package on
the CPU (the checks of tests/test_torch_zoo.py), and the Gym's
concatenation of the zoo's posteriors."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_zoo_common import (B, binary_images, elbo_matches_jax, make_pair,
                              step_matches_jax, tiny_networks)

torch.set_num_threads(2)

CLASSES = {
    "irmVAE": dict(irm_units=8, n_layers=3),
    "irmVAE-shared": dict(irm_units=32, n_layers=2, share_weights=True),
    "irmAE": dict(irm_units=8),
}


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_class_matches_jax(case):
  pair = make_pair(case.split("-")[0], **CLASSES[case])
  elbo_matches_jax(pair, binary_images(B, 60))
  step_matches_jax(pair, binary_images(B, 61))


def _targets(seed):
  return np.random.RandomState(seed).randn(B, 5).astype(np.float32)


def test_dist_encoder_matches_jax():
  from odin_tpu.bay.random_variable import RVconf as JaxRVconf
  from odin_tpu_torch.bay.random_variable import RVconf
  nets, jnets = tiny_networks("torch"), tiny_networks("jax")
  nets["latents"] = RVconf(5, "normal", name="targets")
  jnets["latents"] = JaxRVconf(5, "normal", name="targets")
  pair = make_pair("DistEncoder", networks=nets, jax_networks=jnets)
  elbo_matches_jax(pair, (binary_images(B, 60), _targets(1)))
  step_matches_jax(pair, (binary_images(B, 61), _targets(2)))


@pytest.mark.parametrize("family", ["VonMisesFisher", "PowerSpherical",
                                    "VectorDeterministic",
                                    "OneHotCategorical", "VectorQuantized"])
def test_concat_of_the_zoo_families_matches_jax(family):
  """The Gym concatenates each batch's posterior: the zoo's families, as
  JAX's ``concat_distributions`` does."""
  from odin_tpu.bay import distributions as jd
  from odin_tpu.bay.helpers import concat_distributions as jconcat
  from odin_tpu_torch.bay import distributions as pd
  from odin_tpu_torch.bay.helpers import concat_distributions
  rs = np.random.RandomState(0)
  parts = []
  for b in (3, 5):
    mu = rs.randn(b, 4).astype(np.float32)
    mu /= np.linalg.norm(mu, axis=-1, keepdims=True)
    parts.append((mu, (rs.rand(b) * 10 + 1).astype(np.float32),
                  rs.randint(0, 4, b)))
  make = {
      "VonMisesFisher": lambda D, m, k, i: D.VonMisesFisher(m, k),
      "PowerSpherical": lambda D, m, k, i: D.PowerSpherical(m, k),
      "VectorDeterministic": lambda D, m, k, i: D.VectorDeterministic(m),
      "OneHotCategorical": lambda D, m, k, i: D.OneHotCategorical(
          logits=m),
      "VectorQuantized": lambda D, m, k, i: D.VectorQuantized(
          codes=m, inputs=2 * m, indices=i),
  }[family]
  got = concat_distributions([make(pd, torch.from_numpy(m),
                                   torch.from_numpy(k), torch.from_numpy(i))
                              for m, k, i in parts])
  want = jconcat([make(jd, jnp.asarray(m), jnp.asarray(k), jnp.asarray(i))
                  for m, k, i in parts])
  np.testing.assert_allclose(got.mean().numpy(), np.asarray(want.mean()),
                             rtol=1e-5, atol=1e-6)
