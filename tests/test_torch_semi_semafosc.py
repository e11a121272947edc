"""semafosc (the decoder always takes the predicted labels; two TrainSteps) of
the port against the JAX package, on the 8x8 networks with a labels head
(``torch_semi_common``; tests/test_torch_semi_semafosc_moons.py: the
half-moons): the ELBO terms at steps 0 and 1,500 with JAX's draws replayed,
each within 1e-5 of the term's largest magnitude, and one training step
(every TrainStep), its metrics within rtol 1e-5 (atol 1e-6) and its params
by ``assert_params_close``."""
from torch_semi_common import matches_jax


def test_semafosc_matches_jax():
  matches_jax("semafosc", moons=False)
