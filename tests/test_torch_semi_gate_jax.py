"""The Semafo family's MI gradient past its gate against the JAX package:
with ``steps_without_mi=0`` the first step already trains through the MI
term; one step of both packages from the same params, JAX's draws
replayed, for each direction of the divergence
(tests/test_torch_semi_gate_semafos.py: semafos's two TrainSteps;
tests/test_torch_semi_gate.py: the gate itself)."""
import pytest

from torch_semi_common import semi_batch, semi_pair
from torch_zoo_common import step_matches_jax


@pytest.mark.parametrize("name", ["SemafoVAE", "RemafoVAE"])
def test_the_mi_gradient_past_the_gate_matches_jax(name):
  """With the gate at step 0 the first step already trains through the MI
  term: the step against the JAX package's, its draws replayed."""
  step_matches_jax(semi_pair(name, steps_without_mi=0),
                   semi_batch(name, 21))
