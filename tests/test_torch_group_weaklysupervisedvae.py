"""WeaklySupervisedVAE with ``strategy='match'`` and ``n_changed=1``
(the zdim - 1 dimensions of lowest symmetric KL shared) of the port against the JAX package on pairs of 8x8 images
(``torch_hier_common.group_matches_jax``): the ELBO terms at steps 0 and
700, the unpaired fallback's terms, and one full training step, JAX's
draws replayed; the mean count of shared dimensions, as JAX's."""
import torch

from torch_hier_common import group_matches_jax, jax_shared, pairs

torch.set_num_threads(2)


def test_matches_jax():
  jvae, vae = group_matches_jax("WeaklySupervisedVAE", strategy="match")
  batch = pairs(83)
  _, _, aux = vae.elbo_components(
      vae.state.params, tuple(torch.from_numpy(b) for b in batch),
      torch.Generator().manual_seed(0), torch.tensor(0))
  assert float(aux["n_shared"]) == jax_shared(jvae, batch)
  assert float(aux["n_shared"]) == 3
