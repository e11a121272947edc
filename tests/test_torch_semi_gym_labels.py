"""The Gym's branch for an objective that needs labels: its ELBO totals
unavailable in both packages' Gyms while the latents are still collected,
on the 8x8 networks and tests/test_torch_semi_gym.py's random images."""
import numpy as np
import pytest

import odin_tpu.bay.vi as jvi
import odin_tpu_torch.bay.vi as vi
from test_torch_semi_gym import _Images
from torch_zoo_common import make_pair


class _NeedsLabels(vi.BetaVAE):
  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    if self._split_inputs(batch)[1] is None:
      raise ValueError("this objective needs labels")
    return super().elbo_components(params, batch, rng, step, training,
                                   mutables)


class _JaxNeedsLabels(jvi.BetaVAE):
  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    if self._split_inputs(batch)[1] is None:
      raise ValueError("this objective needs labels")
    return super().elbo_components(params, batch, rng, step, training,
                                   mutables)


def test_an_objective_that_needs_labels_leaves_the_elbo_unavailable(
    monkeypatch):
  monkeypatch.setattr(vi, "NeedsLabels", _NeedsLabels, raising=False)
  monkeypatch.setattr(jvi, "NeedsLabels", _JaxNeedsLabels, raising=False)
  jvae, vae = make_pair("NeedsLabels")
  gym = vi.DisentanglementGym(dataset=_Images(), model=vae,
                              batch_size=64).run_model(n_samples=64)
  jgym = jvi.DisentanglementGym(dataset=_Images(), model=jvae, batch_size=64)
  jgym.run_model(n_samples=64)
  assert gym._llk_total is None and gym._kl_total is None
  assert jgym._llk_total is None and jgym._kl_total is None
  np.testing.assert_allclose(gym.z_mean.numpy(), jgym.z_mean, rtol=0,
                             atol=1e-5)
  assert gym.mig_score() == pytest.approx(jgym.mig_score(), abs=1e-6)
