"""DIPVAE of the port (PyTorch port of
``odin_tpu/bay/vi/autoencoder/dip_vae.py``)."""
from __future__ import annotations

import torch

from odin_tpu_torch.bay.vi.autoencoder.beta_vae import BetaVAE
from odin_tpu_torch.bay.vi.losses import disentangled_inferred_prior_loss

__all__ = ["DIPVAE"]


class DIPVAE(BetaVAE):
  """DIP-VAE (Kumar et al. 2018): the aggregate posterior's covariance is
  held to the identity; `only_mean=True` is type 'i' (Cov[E(z)]), else
  type 'ii' (E[Cov(z)] + Cov[E(z)])."""

  def __init__(self,
               only_mean: bool = False,
               lambda_diag: float = 1.0,
               lambda_offdiag: float = 2.0,
               beta: float = 1.0,
               **kwargs):
    super().__init__(beta=beta, **kwargs)
    self.only_mean = bool(only_mean)
    self.lambda_diag = float(lambda_diag)
    self.lambda_offdiag = float(lambda_offdiag)

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    llk, kl, aux = super().elbo_components(params, batch, rng, step,
                                           training=training,
                                           mutables=mutables)
    dip = disentangled_inferred_prior_loss(aux["qz"],
                                           only_mean=self.only_mean,
                                           lambda_offdiag=self.lambda_offdiag,
                                           lambda_diag=self.lambda_diag)
    z = aux["z"]
    kl["dip_latents"] = dip * torch.ones(z.shape[0], dtype=z.dtype,
                                         device=z.device)
    return llk, kl, aux
