"""Distribution library of the port: every family of the JAX package's
``odin_tpu/bay/distributions``."""
from odin_tpu_torch.bay.distributions.base import (
    Distribution,
    Independent,
    exact_kl,
    kl_registry_lookup,
    register_kl,
)
from odin_tpu_torch.bay.distributions.conditional import ConditionalTensor
from odin_tpu_torch.bay.distributions.continuous import (
    Beta,
    Dirichlet,
    Gamma,
    Laplace,
    Logistic,
    LogNormal,
    LogUniform,
    MultivariateNormalDiag,
    MultivariateNormalTriL,
    Normal,
    NormalGamma,
    Uniform,
)
from odin_tpu_torch.bay.distributions.deterministic import (
    Batchwise,
    Deterministic,
    VectorDeterministic,
)
from odin_tpu_torch.bay.distributions.discrete import (
    Bernoulli,
    Binomial,
    Categorical,
    ContinuousBernoulli,
    DirichletMultinomial,
    Multinomial,
    NegativeBinomial,
    NegativeBinomialDisp,
    OneHotCategorical,
    Poisson,
    RelaxedBernoulli,
    RelaxedOneHotCategorical,
    ZeroInflated,
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
