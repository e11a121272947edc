"""The port's zoo classes with extra partitions or steps against the JAX
package on the CPU (the checks of tests/test_torch_zoo.py): TwoStageVAE
(a 'stage2' partition and step), VampriorVAE (a 'pseudo_inputs'
partition in the VAE's step) and StochasticVAE (two steps on one
partition and one optimizer, the second on the params the first
updated)."""
import numpy as np
import pytest
import torch

from torch_zoo_common import (B, binary_images, elbo_matches_jax, make_pair,
                              step_matches_jax)

torch.set_num_threads(2)

CLASSES = {
    "TwoStageVAE": dict(stage2_units=16, udim=3),
    "VampriorVAE": dict(n_components=5),
    "StochasticVAE": {},
}


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_class_matches_jax(case):
  pair = make_pair(case.split("-")[0], **CLASSES[case])
  elbo_matches_jax(pair, binary_images(B, 60))
  step_matches_jax(pair, binary_images(B, 61))


def test_stochastic_vae_second_step_sees_the_first_update():
  """Both steps share the 'vae' optimizer: its count moves twice a step."""
  _, vae = make_pair("StochasticVAE")
  s, m = vae.make_step_fn()(vae.state, binary_images(B, 6))
  assert set(s.opt_states) == {"vae"}
  assert int(s.opt_states["vae"]["count"]) == 2
  assert {"posterior/loss", "likelihood/loss"} <= set(m)


def test_two_stage_partitions_and_prior():
  jvae, vae = make_pair("TwoStageVAE", stage2_units=16)
  assert set(vae.state.params) == set(jvae.state.params) == {"vae", "stage2"}
  z = vae.sample_prior(6, seed=1)
  assert z.shape == (6, vae.zdim) and torch.isfinite(z).all()


def test_vamprior_pseudo_inputs_train_with_the_vae():
  _, vae = make_pair("VampriorVAE", n_components=5)
  step = vae.make_step_fn()
  assert set(vae.state.opt_states) == {"vae"}
  assert set(vae.state.opt_states["vae"]["mu"]) == {"vae", "pseudo_inputs"}
  s, _ = step(vae.state, binary_images(B, 7))
  assert not torch.equal(s.params["pseudo_inputs"]["pseudo_inputs"],
                         vae.state.params["pseudo_inputs"]["pseudo_inputs"])
