"""Factor2VAE of the port (FactorVAE's objective on a mixed posterior)
against the JAX package on the CPU: the checks of
tests/test_torch_zoo_factor.py's ``check_class``, the discriminator's Adam
state included."""
import pytest
import torch

from test_torch_zoo_factor import DISC, check_class
from torch_zoo_common import make_pair

torch.set_num_threads(2)

CLASSES = {"Factor2VAE": dict(tc_coef=7.0, **DISC)}


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_class_matches_jax(case):
  check_class(make_pair(case, drop=("latents",), **CLASSES[case]))
