"""The VAE zoo of the port (the beta-VAE so far)."""
from odin_tpu_torch.bay.vi.autoencoder.beta_vae import BetaVAE
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    VAECore,
    VariationalAutoencoder,
)
