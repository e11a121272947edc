"""M2's and ADGM's entropy term on a Gaussian labels head, against the
JAX package: NaN in the same rows of both."""
import numpy as np
import pytest
import torch

from odin_tpu_torch.bay.random_variable import RVconf


@pytest.mark.parametrize("name", ["M2VAE", "auxiliaryVAE"])
def test_a_gaussian_labels_head_gives_nan_entropy_in_both(name):
  """On a Gaussian labels head (dSprites' 5-factor regression) the JAX
  package's ``H_qy = -sum p log(p + 1e-6)`` reads q(y|x)'s mean as
  probabilities and is NaN where a mean is negative; the port computes the
  same, row for row."""
  import jax
  from odin_tpu.bay.random_variable import RVconf as JaxRVconf
  from odin_tpu_torch.training import Noise
  from torch_semi_common import semi_batch, semi_networks
  from torch_zoo_common import jit_with_draws, make_pair, to_torch
  nets, jnets = semi_networks(name, "torch"), semi_networks(name, "jax")
  nets["labels"] = RVconf(3, "gaussian", projection=True, name="factors")
  jnets["labels"] = JaxRVconf(3, "gaussian", projection=True, name="factors")
  jvae, vae = make_pair(name, networks=nets, jax_networks=jnets)
  batch = semi_batch("SemafoVAE", 3)  # Gaussian factor labels
  (jl, _), draws = jit_with_draws(lambda p, b: jvae.elbo_components(
      p, b, jax.random.PRNGKey(0), 0)[:2])(jvae.state.params, batch)
  l, _, _ = vae.elbo_components(vae.state.params, tuple(
      torch.from_numpy(a) for a in batch), Noise(eps=to_torch(draws)), 0)
  want = np.isnan(np.asarray(jl["H_qy"]))
  assert want.any()
  np.testing.assert_array_equal(np.isnan(l["H_qy"].numpy()), want)
