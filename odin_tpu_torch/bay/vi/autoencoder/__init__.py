"""The VAE zoo of the port (the beta-VAE family so far)."""
from odin_tpu_torch.bay.vi.autoencoder.beta_vae import (
    AnnealingVAE,
    Beta10VAE,
    BetaCapacityVAE,
    BetaGammaVAE,
    BetaTCVAE,
    BetaVAE,
    Gamma10VAE,
)
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    VAECore,
    VariationalAutoencoder,
)
