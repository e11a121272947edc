"""The port's ImputeVAE against the JAX package on the CPU: the checks of
tests/test_torch_zoo.py, and ``impute`` (the masked entries filled in
from the model, the observed ones kept) within rtol 1e-5."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_zoo_common import (B, binary_images, elbo_matches_jax, make_pair,
                              step_matches_jax)

torch.set_num_threads(2)

CLASSES = {"ImputeVAE": {}}


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_class_matches_jax(case):
  pair = make_pair(case, **CLASSES[case])
  elbo_matches_jax(pair, binary_images(B, 60))
  step_matches_jax(pair, binary_images(B, 61))


def test_impute_matches_jax():
  jvae, vae = make_pair("ImputeVAE")
  x = binary_images(B, 9)
  mask = (np.random.RandomState(3).rand(*x.shape) < 0.7).astype(np.float32)
  want = jvae.impute(jnp.asarray(x), jnp.asarray(mask), n_iter=3)
  got = vae.impute(x, mask, n_iter=3)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-6)
  np.testing.assert_array_equal(got.numpy()[mask == 1], x[mask == 1])
