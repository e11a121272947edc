"""The VAE zoo of the port and its registry (``get_vae``, ``get_all_vae``:
the JAX package's lookup rules, ``odin_tpu/bay/vi/autoencoder/
__init__.py:114-141``), which names every class the JAX package
registers."""
import inspect
from typing import Type, Union

from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    VAE,
    Autoencoder,
    VAECore,
    VariationalAutoencoder,
    masked_mean_llk,
)
from odin_tpu_torch.bay.vi.autoencoder.auxiliary_vae import (
    AuxiliaryVAE,
    auxiliaryVAE,
)
from odin_tpu_torch.bay.vi.autoencoder.beta_vae import (
    AnnealingVAE,
    Beta10VAE,
    BetaCapacityVAE,
    BetaGammaVAE,
    BetaTCVAE,
    BetaVAE,
    Gamma10VAE,
)
from odin_tpu_torch.bay.vi.autoencoder.conditional_vae import (
    ConditionalM2VAE,
    M2VAE,
    PriorRegressor,
    StructuredSemiVAE,
    reparamsM3VAE,
)
from odin_tpu_torch.bay.vi.autoencoder.cycle_vae import CycleConsistentVAE
from odin_tpu_torch.bay.vi.autoencoder.deterministic import DistEncoder
from odin_tpu_torch.bay.vi.autoencoder.dip_vae import DIPVAE
from odin_tpu_torch.bay.vi.autoencoder.factor_discriminator import (
    FactorDiscriminator,
)
from odin_tpu_torch.bay.vi.autoencoder.factor_vae import (
    Factor2VAE,
    FactorVAE,
    SemiFactor2VAE,
    SemiFactorVAE,
)
from odin_tpu_torch.bay.vi.autoencoder.hierarchical_vae import (
    BiConvLatents,
    BiDenseLatents,
    HierarchicalVAE,
    LadderCore,
    LadderVAE,
    ParallelLatents,
    PUnetCore,
    PUnetVAE,
    UnetCore,
    UnetVAE,
    VeryDeepVAE,
)
from odin_tpu_torch.bay.vi.autoencoder.hyperbolic_vae import (
    HypersphericalVAE,
    PowersphericalVAE,
)
from odin_tpu_torch.bay.vi.autoencoder.info_vae import MIVAE, InfoVAE
from odin_tpu_torch.bay.vi.autoencoder.irm_vae import (
    ImplicitRankMinimizer,
    irmAE,
    irmVAE,
)
from odin_tpu_torch.bay.vi.autoencoder.lda_vae import (
    ALDA,
    LatentDirichletDecoder,
    amortizedLDA,
    auxiliaryLDA,
    nonlinearLDA,
)
from odin_tpu_torch.bay.vi.autoencoder.moe_vae import MoeVAE
from odin_tpu_torch.bay.vi.autoencoder.multitask_vae import (
    MultiheadVAE,
    MultitaskVAE,
    SkiptaskVAE,
)
from odin_tpu_torch.bay.vi.autoencoder.semafo_vae import (
    RemafoVAE,
    SemafoVAE,
    semafod,
    semafoh,
    semafop,
    semafos,
    semafosc,
    semafosm,
    semafot,
)
from odin_tpu_torch.bay.vi.autoencoder.self_supervised_vae import (
    AdaptiveVAE,
    GroupVAE,
    MultiLevelVAE,
    WeaklySupervisedVAE,
)
from odin_tpu_torch.bay.vi.autoencoder.sequential_vae import (
    SequentialAttentionVAE,
    SequentialVAE,
    VariationalRNN,
)
from odin_tpu_torch.bay.vi.autoencoder.stochastic_vae import (
    ImputeVAE,
    StochasticVAE,
)
from odin_tpu_torch.bay.vi.autoencoder.two_stage_vae import TwoStageVAE
from odin_tpu_torch.bay.vi.autoencoder.vamprior import VampriorVAE
from odin_tpu_torch.bay.vi.autoencoder.vq_vae import VQVAE, VectorQuantizer

__all__ = [
    "VariationalAutoencoder", "VAE", "VAECore", "Autoencoder", "BetaVAE",
    "Beta10VAE", "BetaGammaVAE", "Gamma10VAE", "AnnealingVAE", "BetaTCVAE",
    "BetaCapacityVAE", "FactorVAE", "Factor2VAE", "SemiFactorVAE",
    "SemiFactor2VAE", "FactorDiscriminator", "DIPVAE", "InfoVAE", "MIVAE",
    "ImplicitRankMinimizer", "irmVAE", "irmAE", "HypersphericalVAE",
    "PowersphericalVAE", "TwoStageVAE", "VampriorVAE", "VQVAE",
    "VectorQuantizer", "StochasticVAE", "ImputeVAE", "DistEncoder",
    "masked_mean_llk", "MultitaskVAE", "SkiptaskVAE",
    "MultiheadVAE", "M2VAE", "ConditionalM2VAE", "StructuredSemiVAE",
    "PriorRegressor", "reparamsM3VAE", "auxiliaryVAE", "AuxiliaryVAE",
    "SemafoVAE", "RemafoVAE", "semafod", "semafoh", "semafos", "semafosm",
    "semafosc", "semafop", "semafot", "HierarchicalVAE", "LadderVAE",
    "UnetVAE", "PUnetVAE", "VeryDeepVAE", "BiConvLatents", "BiDenseLatents",
    "ParallelLatents", "LadderCore", "UnetCore", "PUnetCore", "GroupVAE",
    "MultiLevelVAE", "AdaptiveVAE", "WeaklySupervisedVAE",
    "LatentDirichletDecoder", "amortizedLDA", "auxiliaryLDA",
    "nonlinearLDA", "ALDA", "VariationalRNN", "SequentialVAE",
    "SequentialAttentionVAE", "CycleConsistentVAE", "MoeVAE", "get_vae",
    "get_all_vae",
]

# the JAX package's registered names that the port has not ported yet:
# none since the last nine classes came
_WAITING = {}


def _zoo():
  return {k.lower(): v for k, v in globals().items()
          if inspect.isclass(v) and issubclass(v, VariationalAutoencoder)}


def get_vae(name: Union[str, Type[VariationalAutoencoder]] = None):
  """A VAE class by its case-insensitive name ('vae' may be left off:
  ``get_vae('beta')`` is ``BetaVAE``); with no name, every class."""
  if name is None:
    return sorted(set(_zoo().values()), key=lambda c: c.__name__)
  if inspect.isclass(name) and issubclass(name, VariationalAutoencoder):
    return name
  key = str(name).lower().replace("_", "")
  zoo = _zoo()
  for k in (key, key + "vae"):
    if k in zoo:
      return zoo[k]
  raise ValueError(f"cannot find VAE with name '{name}'; "
                   f"available: {sorted(zoo)}")


def get_all_vae():
  return get_vae(None)
