"""Distribution heads and layers of the port."""
from odin_tpu_torch.bay.layers.autoregressive import AutoregressiveDense
from odin_tpu_torch.bay.layers.dense_distribution import (
    DenseDeterministic,
    DistributionDense,
    DistributionNetwork,
    MergeNormal,
    MixtureDensityNetwork,
    MixtureMassNetwork,
    MixtureMVNDiagLatents,
    MixtureNormalLatents,
    MVNDiagLatents,
    NormalLatents,
    merge_normal,
)
from odin_tpu_torch.bay.layers.distribution_layers import *  # noqa: F401,F403
from odin_tpu_torch.bay.layers.util_layers import (
    ConditionalTensorLayer,
    DistributionAttr,
    Moments,
    Sampling,
    Stddev,
)
