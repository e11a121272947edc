"""Distribution library of the port (the families the dSprites beta-VAE
serves through)."""
from odin_tpu_torch.bay.distributions.base import (
    Distribution,
    Independent,
    exact_kl,
    kl_registry_lookup,
    register_kl,
)
from odin_tpu_torch.bay.distributions.continuous import (
    MultivariateNormalDiag,
    Normal,
)
from odin_tpu_torch.bay.distributions.discrete import Bernoulli
