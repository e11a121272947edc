"""VeryDeepVAE of the port against the JAX package: the ELBO terms at
steps 0, 700 and 5,000 (inside and past the KL warm-up of 2,000 steps) and
one full training step, JAX's draws replayed; the warm-up read from the
step tensor, as JAX's ``linear`` schedule."""
import numpy as np
import torch

import jax.numpy as jnp

from torch_hier_common import hier_matches_jax

torch.set_num_threads(2)


def test_matches_jax_across_the_warm_up():
  jvae, vae = hier_matches_jax("VeryDeepVAE", steps=(0, 700, 5000))
  for step in (0, 1, 999, 2000, 2500):
    np.testing.assert_allclose(
        float(vae._kl_schedule(torch.tensor(step, dtype=torch.int32))),
        float(jvae._kl_schedule(jnp.int32(step))), rtol=1e-6)
