"""The port's DIPVAE, types i and ii, against the JAX package on the CPU
(the checks of tests/test_torch_zoo.py: the ELBO terms and the loss at
steps 0 and 700, then one full training step)."""
import pytest
import torch

from torch_zoo_common import (B, binary_images, elbo_matches_jax, make_pair,
                              step_matches_jax)

torch.set_num_threads(2)

CLASSES = {
    "DIPVAE-i": dict(only_mean=True),
    "DIPVAE-ii": dict(only_mean=False, lambda_diag=3.0, lambda_offdiag=5.0),
}


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_class_matches_jax(case):
  pair = make_pair(case.split("-")[0], **CLASSES[case])
  elbo_matches_jax(pair, binary_images(B, 60))
  step_matches_jax(pair, binary_images(B, 61))
