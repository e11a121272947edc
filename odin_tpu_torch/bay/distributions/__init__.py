"""Distribution library of the port: the families the VAEs of the port
serve and train through."""
from odin_tpu_torch.bay.distributions.base import (
    Distribution,
    Independent,
    exact_kl,
    kl_registry_lookup,
    register_kl,
)
from odin_tpu_torch.bay.distributions.continuous import (
    Dirichlet,
    Logistic,
    MultivariateNormalDiag,
    Normal,
    Uniform,
)
from odin_tpu_torch.bay.distributions.deterministic import (
    Deterministic,
    VectorDeterministic,
)
from odin_tpu_torch.bay.distributions.discrete import (
    Bernoulli,
    Categorical,
    OneHotCategorical,
)
from odin_tpu_torch.bay.distributions.mixture import (
    GaussianMixture,
    MixtureSameFamily,
)
from odin_tpu_torch.bay.distributions.quantized import (
    MixtureQuantizedLogistic,
    Quantized,
    QuantizedLogistic,
    qNormal,
    qUniform,
)
from odin_tpu_torch.bay.distributions.spherical import (
    PowerSpherical,
    SphericalUniform,
    VonMisesFisher,
)
from odin_tpu_torch.bay.distributions.vector_quantizer import VectorQuantized
