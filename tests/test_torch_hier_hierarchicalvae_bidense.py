"""HierarchicalVAE with a ``BiDenseLatents`` rung (``latents='bidense'``:
Dense heads on the flattened states, the merge broadcast back onto the
spatial state) against the JAX package: the ELBO terms at steps 0 and 700
and one full training step, JAX's draws replayed."""
import torch

from torch_hier_common import hier_matches_jax

torch.set_num_threads(2)


def test_matches_jax():
  hier_matches_jax("HierarchicalVAE", latents="bidense")
