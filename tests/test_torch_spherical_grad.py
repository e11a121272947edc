"""The gradients of the port's spherical distributions against the JAX
package's on the CPU, continued from tests/test_torch_spherical.py:
log_prob, entropy, mean and the KL to the uniform through kappa and mu,
rtol 1e-4 (atol 1e-5)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from odin_tpu.bay.distributions import spherical as jax_sph
from odin_tpu.bay.helpers import kl_divergence as jax_kl
from odin_tpu_torch.bay.distributions import spherical as sph
from odin_tpu_torch.bay.helpers import kl_divergence
from test_torch_spherical import KAPPAS, _params

torch.set_num_threads(2)


@pytest.mark.parametrize("family,d", [
    ("VonMisesFisher", 3), ("VonMisesFisher", 64), ("PowerSpherical", 3),
    ("PowerSpherical", 10), ("PowerSpherical", 64)])
def test_gradients_through_kappa_and_mu_match_jax(family, d):
  mu, x = _params(d, seed=1)

  def total(q, uniform, kl, x):
    return (q.log_prob(x).sum() + q.entropy().sum() + q.mean().sum() +
            kl(q, uniform, analytic=True).sum())

  jax_fn = jax.grad(lambda m, k: total(getattr(jax_sph, family)(m, k),
                                       jax_sph.SphericalUniform(d), jax_kl,
                                       jnp.asarray(x)), argnums=(0, 1))
  jm, jk = jax_fn(jnp.asarray(mu), jnp.asarray(KAPPAS))
  m = torch.from_numpy(mu).requires_grad_()
  k = torch.from_numpy(KAPPAS).requires_grad_()
  total(getattr(sph, family)(m, k), sph.SphericalUniform(d), kl_divergence,
        torch.from_numpy(x)).backward()
  np.testing.assert_allclose(k.grad.numpy(), np.asarray(jk), rtol=1e-4,
                             atol=1e-5)
  np.testing.assert_allclose(m.grad.numpy(), np.asarray(jm), rtol=1e-4,
                             atol=1e-5)
