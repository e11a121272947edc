"""UnetVAE's ``skip_dropout`` at 0.5 (a Bernoulli mask on the
skip's units, rescaled by the keep rate) against the JAX package: the ELBO terms in training mode
and one full training step, JAX's draws replayed
(``torch_hier_common.unet_knob_matches_jax``)."""
import pytest
import torch

from torch_hier_common import unet_knob_matches_jax

torch.set_num_threads(2)


@pytest.mark.parametrize("knob,rate", [("skip_dropout", 0.5)])
def test_knob_matches_jax(knob, rate):
  draws = unet_knob_matches_jax(knob, rate)
  assert len(draws) == 2  # z, then the mask, the gate or the skip's noise
