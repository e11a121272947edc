"""HypersphericalVAE (von Mises-Fisher) and PowersphericalVAE of the port
against the JAX package on the CPU (the checks of
tests/test_torch_zoo.py, JAX's vMF cosines and log-Gamma draws injected),
and the vMF model trained from the port's own sampler: every row
accepted, the loss finite."""
import pytest
import torch

from odin_tpu_torch.bay.distributions import sampling
from torch_zoo_common import (B, binary_images, elbo_matches_jax, make_pair,
                              step_matches_jax)

torch.set_num_threads(2)


@pytest.mark.parametrize("cls", ["HypersphericalVAE", "PowersphericalVAE"])
def test_class_matches_jax(cls):
  pair = make_pair(cls)
  elbo_matches_jax(pair, binary_images(B, 60))
  step_matches_jax(pair, binary_images(B, 61))


def test_vmf_model_steps_on_its_own_draws():
  sampling.reset_rejection_stats()
  _, vae = make_pair("HypersphericalVAE")
  step = vae.make_step_fn()
  s = vae.state
  for i in range(3):
    s, m = step(s, binary_images(B, i))
  assert torch.isfinite(m["loss"]) and int(s.skipped_updates) == 0
  stats = sampling.rejection_stats()["vmf@cpu"]
  assert stats["rows"] == 3 * B and stats["failed"] == 0
  assert stats["accepted"] > 0.5 * stats["proposals"]
