"""BetaVAE of the port (``odin_tpu/bay/vi/autoencoder/beta_vae.py:27``):
``ELBO = llk - beta * kl``; the objective comes with the training slice."""
from __future__ import annotations

from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    VariationalAutoencoder,
)

__all__ = ["BetaVAE"]


class BetaVAE(VariationalAutoencoder):
  """beta-VAE (Higgins et al. ICLR'17)."""

  def __init__(self, beta: float = 1.0, **kwargs):
    super().__init__(**kwargs)
    self.beta = beta
