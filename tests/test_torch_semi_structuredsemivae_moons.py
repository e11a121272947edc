"""StructuredSemiVAE of the port against the JAX package, on the half-moons
MLPs with their one-hot head (``torch_semi_common``;
tests/test_torch_semi_structuredsemivae.py: the 8x8 networks): the ELBO
terms at steps 0 and 1,500 with JAX's draws replayed, each within 1e-5 of
the term's largest magnitude, and one training step (every TrainStep), its
metrics within rtol 1e-5 (atol 1e-6) and its params by
``assert_params_close``."""
from torch_semi_common import matches_jax


def test_structuredsemivae_on_the_moons_matches_jax():
  matches_jax("StructuredSemiVAE", moons=True)
