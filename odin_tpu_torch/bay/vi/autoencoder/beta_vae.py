"""BetaVAE of the port (``odin_tpu/bay/vi/autoencoder/beta_vae.py:27-44``):
``ELBO = llk - beta * kl``, beta a float or an ``Interpolation`` of the
training step."""
from __future__ import annotations

from typing import Union

from odin_tpu_torch.backend.interpolation import Interpolation
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    VariationalAutoencoder,
)

__all__ = ["BetaVAE"]


class BetaVAE(VariationalAutoencoder):
  """beta-VAE (Higgins et al. ICLR'17)."""

  def __init__(self, beta: Union[float, Interpolation] = 1.0, **kwargs):
    super().__init__(**kwargs)
    self.beta = beta

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    llk, kl, aux = super().elbo_components(params, batch, rng, step,
                                           training=training,
                                           mutables=mutables)
    beta = self._schedule(self.beta, step)
    kl = {k: beta * v for k, v in kl.items()}
    return llk, kl, aux
