"""HierarchicalVAE (alias LadderVAE) of the port against the JAX package on
the 8x8 networks with a BiConv ladder rung (``torch_hier_common``): the
ELBO terms (``kl_ladder0`` with its free bits scaled by the rung's event
size) at steps 0 and 700 and one full training step, JAX's draws
replayed; then the port's own surface: the alias, the required spec, the
Gym's KL as the model's own KL terms, evaluation through the posterior
path, and ancestral sampling."""
import numpy as np
import pytest
import torch

import odin_tpu_torch.bay.vi as port_vi
from odin_tpu_torch.bay.vi import DisentanglementGym
from odin_tpu_torch.training import Noise
from torch_hier_common import hier_matches_jax, ladder_networks

torch.set_num_threads(2)


def test_matches_jax():
  hier_matches_jax("HierarchicalVAE")


def test_ladder_alias_and_registry():
  assert port_vi.LadderVAE is port_vi.HierarchicalVAE
  assert port_vi.get_vae("laddervae") is port_vi.HierarchicalVAE
  assert port_vi.get_vae("hierarchical") is port_vi.HierarchicalVAE
  nets = ladder_networks("torch")
  nets.pop("hierarchy")
  with pytest.raises(ValueError, match="hierarchy"):
    port_vi.HierarchicalVAE(**nets)


def test_gym_reads_the_posterior_path_and_the_models_kl():
  """The port's counterpart of JAX's tests/test_gym.py:157: after 25
  steps the Gym's log-likelihood (reconstructions through the posterior
  path) is of the training llk's order; its per-sample KL is the sum of
  the model's own ELBO KL terms, the rung's included."""
  vae = port_vi.HierarchicalVAE(**ladder_networks("torch")).build(
      seed=0, device="cpu")
  rs = np.random.RandomState(0)
  X = (rs.rand(96, 8, 8, 1) < 0.4).astype(np.float32)
  step = vae.make_step_fn(learning_rate=3e-3)
  for _ in range(25):
    vae.state, _ = step(vae.state, torch.from_numpy(X[rs.randint(0, 96, 16)]))
  xb = torch.from_numpy(X[:32])
  with torch.no_grad():
    llk, kl, _ = vae.elbo_components(
        vae.state.params, xb, Noise(torch.Generator().manual_seed(1)),
        vae.state.step)
  train_llk = float(llk["llk_image"].mean())
  gym = DisentanglementGym(model=vae, x=X, y=rs.randint(0, 3, (96, 2)),
                           batch_size=32, device="cpu")
  gym.run_model(n_samples=96)
  gym_llk = gym.log_likelihood()
  assert np.isfinite(gym_llk)
  assert abs(gym_llk - train_llk) < 0.5 * abs(train_llk) + 5.0
  np.testing.assert_allclose(gym.kl_divergence_values()[:32].numpy(),
                             (kl["kl_latents"] + kl["kl_ladder0"]).numpy(),
                             rtol=1e-6)
  # the posterior path decodes with the rung's posterior: it differs from
  # a generation-mode decode of the same z
  qz, px = vae.reconstruct(xb)
  assert not torch.allclose(px.mean(), vae.decode(qz.mean()).mean())
  px = vae.sample_observation(5, seed=3)
  assert px.mean().shape == (5, 8, 8, 1)
  assert torch.isfinite(px.mean()).all()
