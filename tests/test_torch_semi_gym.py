"""The Gym on the semi-supervised family, as the JAX package runs it:
``run_model`` and MIG on M2VAE (whose encode and reconstruct go through
its classifier) against the JAX package's Gym on the same weights and
images, JAX's ELBO draws replayed, on the 8x8 networks and a dataset of
random 8x8 images and factors (tests/test_torch_semi_gym_labels.py: an
objective that needs labels)."""
import numpy as np
import pytest
import torch

import jax

import odin_tpu.bay.vi as jvi
import odin_tpu_torch.bay.vi as vi
from torch_semi_common import semi_pair
from torch_zoo_common import binary_images

N = 64


class _Images:
  """What a Gym reads of a dataset: ``numpy(partition)`` and the factor
  names."""

  labels = ["a", "b", "c"]

  def numpy(self, partition):
    rs = np.random.RandomState(0)
    return binary_images(N, 5), rs.randint(0, 4, (N, 3)).astype(np.float32)


def test_gym_on_m2_matches_jax():
  jvae, vae = semi_pair("M2VAE")
  jgym = jvi.DisentanglementGym(dataset=_Images(), model=jvae, batch_size=64)
  jgym.run_model(n_samples=N, partition="test")
  # the one draw of every batch's ELBO: elbo_components splits the Gym's
  # key, _components_xy splits the second half and samples q(z|x, y) from
  # its second half, (batch, zdim) standard normals
  key = jax.random.split(jax.random.split(jax.random.PRNGKey(jgym.seed))[1])
  eps = np.array(jax.random.normal(key[1], (64, vae.zdim)))
  gym = vi.DisentanglementGym(dataset=_Images(), model=vae, batch_size=64)
  gym.run_model(n_samples=N, partition="test", eps=torch.from_numpy(eps))
  np.testing.assert_array_equal(gym.x_true, jgym.x_true)
  np.testing.assert_allclose(gym.z_mean.numpy(), jgym.z_mean, rtol=0,
                             atol=1e-5)
  np.testing.assert_allclose(gym.px.mean().numpy(),
                             np.asarray(jgym.px.mean()), rtol=0, atol=1e-5)
  np.testing.assert_allclose(gym.log_likelihood_values().numpy(),
                             jgym.log_likelihood_values(), rtol=1e-4)
  np.testing.assert_allclose(gym.kl_divergence_values().numpy(),
                             jgym.kl_divergence_values(), rtol=1e-4)
  # the posterior mean goes through the classifier's q(y|x) mean
  x = torch.from_numpy(gym.x_true[:8])
  qy = vae.classify(x)
  want = vae._core(vae.state.params, "encode_xy", x, qy.mean()).mean()
  assert torch.equal(vae.encode(x).mean(), want)
  assert gym.mig_score() == pytest.approx(jgym.mig_score(), abs=1e-6)
