"""semafos's MI gradient past its gate against the JAX package: with
``steps_without_mi=0`` its ELBO step trains through the MI term of the
conditional decoder, then its supervised step runs on the same optimizer;
one iteration of both packages from the same params, JAX's draws
replayed."""
from torch_semi_common import semi_batch, semi_pair
from torch_zoo_common import step_matches_jax


def test_semafos_mi_gradient_past_the_gate_matches_jax():
  step_matches_jax(semi_pair("semafos", steps_without_mi=0),
                   semi_batch("semafos", 21))
