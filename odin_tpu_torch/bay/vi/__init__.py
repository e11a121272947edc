"""Variational inference of the port."""
from odin_tpu_torch.bay.vi._base import VariationalModel
from odin_tpu_torch.bay.vi.autoencoder import (
    BetaVAE,
    VAECore,
    VariationalAutoencoder,
)
