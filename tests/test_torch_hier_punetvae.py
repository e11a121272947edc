"""PUnetVAE of the port against the JAX package: the ELBO terms
(``kl_ladder0``: the Dense posterior head on the flattened encoder state
against the prior head on the flattened decoder state, beta-scaled) at
steps 0 and 700 and one full training step, JAX's draws replayed; its
reconstruction at the posterior mean."""
import numpy as np
import torch

import jax

from torch_hier_common import B, hier_matches_jax
from torch_zoo_common import binary_images

torch.set_num_threads(2)


def test_matches_jax():
  jvae, vae = hier_matches_jax("PUnetVAE", ladder_units=3)
  x = binary_images(B, 72)
  jqz, jpx = jvae.reconstruct(x)
  qz, px = vae.reconstruct(torch.from_numpy(x))
  np.testing.assert_allclose(qz.mean().numpy(), np.asarray(jqz.mean()),
                             rtol=1e-5, atol=1e-6)
  np.testing.assert_allclose(px.mean().detach().numpy(),
                             np.asarray(jax.device_get(jpx.mean())),
                             rtol=1e-5, atol=1e-6)
