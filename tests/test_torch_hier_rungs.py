"""The ladder rungs of the port (``BiConvLatents``, ``ParallelLatents``,
``BiDenseLatents``) against the JAX package's flax modules on the same
params (``torch_hier_common.rung_matches_jax``: the posterior, a given z,
generation from the prior, and a sample with JAX's draw replayed), at
kernel 8, stride 4, 'SAME' on dSprites' 16x16 rung state: flax's bare
``nn.Conv``/``nn.ConvTranspose``, where the port's ``same_padding`` and
``conv_transpose_padding`` had been held at kernel 4, stride 2 only."""
import pytest
import torch

from odin_tpu_torch.bay.vi.autoencoder.hierarchical_vae import BiConvLatents
from torch_hier_common import KINDS, rung_matches_jax


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_rung_matches_jax(kind):
  rung_matches_jax(kind, "dsprites-16x16-k8s4")


def test_rung_without_noise_raises():
  """A rung draws only from the Noise its model hands the core."""
  rung = BiConvLatents(4, 3, 2, 8)
  rung.build((8, 8, 8), (8, 8, 8), torch.Generator().manual_seed(0))
  with pytest.raises(RuntimeError, match="Noise"):
    rung(torch.zeros(2, 8, 8, 8), torch.zeros(2, 8, 8, 8))
