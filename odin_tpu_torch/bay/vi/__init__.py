"""Variational inference of the port."""
from odin_tpu_torch.bay.vi._base import VariationalModel, traverse_dims
from odin_tpu_torch.bay.vi.autoencoder import (
    AnnealingVAE,
    Beta10VAE,
    BetaCapacityVAE,
    BetaGammaVAE,
    BetaTCVAE,
    BetaVAE,
    Gamma10VAE,
    VAECore,
    VariationalAutoencoder,
)
from odin_tpu_torch.bay.vi.losses import total_correlation
