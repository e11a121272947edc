"""The ladder rungs of the port against the JAX package's flax modules on
the same params (``torch_hier_common.rung_matches_jax``), at kernel 3,
stride 2 on the 8x8 state of the test networks' rung."""
import pytest

from torch_hier_common import KINDS, rung_matches_jax


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_rung_matches_jax(kind):
  rung_matches_jax(kind, "tiny-8x8-k3s2")
