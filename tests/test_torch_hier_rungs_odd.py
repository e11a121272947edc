"""The ladder rungs of the port against the JAX package's flax modules on
the same params (``torch_hier_common.rung_matches_jax``), at kernel 8,
stride 4 on an odd 13x13 state: XLA's uneven 'SAME' padding, and the
transposed conv's 16x16 output cropped to the state's grid at the NHWC
boundary."""
import pytest

from torch_hier_common import KINDS, rung_matches_jax


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_rung_matches_jax(kind):
  rung_matches_jax(kind, "odd-13x13-k8s4")
