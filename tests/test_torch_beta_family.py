"""The port's beta-VAE family against the JAX package on the CPU.

Each of ``Beta10VAE``, ``BetaGammaVAE``, ``Gamma10VAE``, ``AnnealingVAE``,
``BetaTCVAE`` and ``BetaCapacityVAE`` on the full-width dSprites networks, both packages
on the same params, batch and noise (tests/torch_training_common.py): the
ELBO terms and the loss at two step counts (the schedules move with the
step) within rtol 1e-5, then one training step by the params rule of
tests/torch_training_common.py.
``total_correlation`` against the JAX package's within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from odin_tpu.bay.distributions import MultivariateNormalDiag as JaxMVN
from odin_tpu.bay.vi.losses import total_correlation as jax_tc
from odin_tpu_torch.bay.distributions import MultivariateNormalDiag
from odin_tpu_torch.bay.vi import total_correlation
from torch_training_common import (ZDIM, binary_images, check_run, make_pair,
                                   run_both)

torch.set_num_threads(2)

RTOL = 1e-5
B = 4
FAMILY = {
    "Beta10VAE": {},
    "Gamma10VAE": {},
    "BetaGammaVAE": dict(beta=2.0, gamma=3.0),
    "AnnealingVAE": {},
    "BetaTCVAE": dict(beta=6.0),
    # C(700) = 70, far from the KL terms (1-20 here): |KL - C| does not
    # cancel, where it would keep only the KL's float32 rounding, magnified
    "BetaCapacityVAE": dict(gamma=10.0, c_max=100.0, n_steps=1000),
}


def _terms(llk, kl):
  return {**llk, **kl}


@pytest.mark.parametrize("cls", sorted(FAMILY))
def test_family_matches_jax(cls):
  pair = make_pair(cls=cls, **FAMILY[cls])
  jvae, vae = pair
  x = binary_images(B, 60)
  key = jax.random.PRNGKey(4)
  eps = np.array(jax.random.normal(jax.random.split(key)[1], (B, ZDIM)))
  jparams = jvae.state.params
  for step in (0, 700):
    jl, jk, _ = jvae.elbo_components(jparams, x, key, jnp.int32(step))
    l, k, _ = vae.elbo_components(vae.state.params, torch.from_numpy(x),
                                  torch.from_numpy(eps),
                                  torch.tensor(step, dtype=torch.int32))
    want, got = _terms(jl, jk), _terms(l, k)
    assert set(got) == set(want)
    for name in want:
      np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                 rtol=RTOL, err_msg=f"{name} at {step}")
    np.testing.assert_allclose(
        (-vae.elbo(l, k).mean()).numpy(),
        np.asarray(-jnp.mean(jvae.elbo(jl, jk))), rtol=RTOL)
  check_run(*run_both(pair, n_steps=1))


def test_total_correlation_matches_jax():
  rs = np.random.RandomState(5)
  loc = rs.randn(16, 6).astype(np.float32)
  scale = np.exp(rs.randn(16, 6).astype(np.float32) * 0.3)
  z = (loc + scale * rs.randn(16, 6)).astype(np.float32)
  want = jax_tc(jnp.asarray(z), JaxMVN(loc, scale))
  got = total_correlation(torch.from_numpy(z),
                          MultivariateNormalDiag(torch.from_numpy(loc),
                                                 torch.from_numpy(scale)))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                             atol=RTOL)
