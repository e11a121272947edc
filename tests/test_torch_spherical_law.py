"""The port's vMF sampler against the JAX package's on the CPU,
continued from tests/test_torch_spherical.py: the law of the port's
fixed-proposal sampler (the mean cosine within 3 standard errors of
A_d(kappa), a two-sample KS test against JAX's while-loop sampler at p >
0.01, no row unaccepted)."""
import numpy as np
import pytest
import torch
from scipy import special, stats

import jax
import jax.numpy as jnp

from odin_tpu.bay.distributions import spherical as jax_sph
from odin_tpu_torch.bay.distributions import sampling, spherical as sph

torch.set_num_threads(2)


def _mean_cosine(d, kappa):
  """A_d(kappa) = I_{d/2}(kappa) / I_{d/2-1}(kappa), in float64."""
  return special.ive(d / 2.0, kappa) / special.ive(d / 2.0 - 1.0, kappa)


@pytest.mark.parametrize("d,kappa", [(3, 1.0), (10, 10.0), (64, 500.0)])
def test_vmf_cosines_follow_the_law_of_jax(d, kappa):
  n = 4000
  sampling.reset_rejection_stats()
  q = sph.VonMisesFisher(torch.nn.functional.normalize(torch.ones(d), dim=0),
                         torch.tensor(kappa))
  w = q._sample_w(torch.Generator().manual_seed(d), (n,)).numpy()
  stats_ = sampling.rejection_stats()["vmf@cpu"]
  assert stats_["failed"] == 0 and stats_["rows"] == n
  assert np.isfinite(w).all() and (np.abs(w) <= 1.0).all()
  se = w.std() / np.sqrt(n)
  assert abs(w.mean() - _mean_cosine(d, kappa)) < 3 * se
  jq = jax_sph.VonMisesFisher(jnp.ones(d) / np.sqrt(d), jnp.float32(kappa))
  jw = np.asarray(jax.jit(lambda key: jq._sample_w(key, (n,)))(
      jax.random.PRNGKey(d)))
  assert stats.ks_2samp(w, jw).pvalue > 0.01


