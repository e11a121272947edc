"""The beta-VAE family of the port (``odin_tpu/bay/vi/autoencoder/
beta_vae.py``): ``BetaVAE``, ``Beta10VAE``, ``BetaGammaVAE``,
``Gamma10VAE``, ``AnnealingVAE``, ``BetaTCVAE`` and ``BetaCapacityVAE``.
Coefficients are floats or ``Interpolation`` schedules of the training
step."""
from __future__ import annotations

from typing import Union

import torch

from odin_tpu_torch.backend import interpolation as interp
from odin_tpu_torch.backend.interpolation import Interpolation, linear
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    VariationalAutoencoder,
)
from odin_tpu_torch.bay.vi.losses import total_correlation

__all__ = ["BetaVAE", "Beta10VAE", "BetaGammaVAE", "Gamma10VAE",
           "AnnealingVAE", "BetaTCVAE", "BetaCapacityVAE"]


class BetaVAE(VariationalAutoencoder):
  """beta-VAE (Higgins et al. ICLR'17): ``ELBO = llk - beta * kl``."""

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


class Beta10VAE(BetaVAE):
  """BetaVAE with beta = 10."""

  def __init__(self, **kwargs):
    kwargs.pop("beta", None)
    super().__init__(beta=10.0, **kwargs)


class BetaGammaVAE(BetaVAE):
  """``ELBO = gamma * llk - beta * kl``."""

  def __init__(self, gamma: Union[float, Interpolation] = 1.0, **kwargs):
    super().__init__(**kwargs)
    self.gamma = gamma

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    llk, kl, aux = super().elbo_components(params, batch, rng, step,
                                           training=training,
                                           mutables=mutables)
    gamma = self._schedule(self.gamma, step)
    llk = {k: gamma * v for k, v in llk.items()}
    return llk, kl, aux


class Gamma10VAE(BetaGammaVAE):
  """BetaGammaVAE with gamma = 10."""

  def __init__(self, **kwargs):
    kwargs.pop("gamma", None)
    super().__init__(gamma=10.0, **kwargs)


class AnnealingVAE(BetaVAE):
  """KL-annealed VAE (Fu et al. 2019; Sønderby et al. 2016): beta linearly
  annealed from 1e-6 to 1 over 2000 steps."""

  def __init__(self, beta: Union[float, Interpolation] = None, **kwargs):
    if beta is None:
      beta = linear(vmin=1e-6, vmax=1.0, steps=2000, delay_in=0)
    super().__init__(beta=beta, **kwargs)


class BetaTCVAE(BetaVAE):
  """beta-TCVAE (Chen et al. 2019): ``ELBO = llk - (kl + (beta - 1) *
  TC)``, the plain KL term unscaled."""

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    llk, kl, aux = VariationalAutoencoder.elbo_components(
        self, params, batch, rng, step, training=training, mutables=mutables)
    qz, z = aux["qz"], aux["z"]
    beta = self._schedule(self.beta, step)
    tc = total_correlation(z.reshape(-1, z.shape[-1]), qz)
    kl["tc_latents"] = (beta - 1.0) * tc * torch.ones_like(
        next(iter(kl.values())))
    return llk, kl, aux


class BetaCapacityVAE(VariationalAutoencoder):
  """Controlled-capacity beta-VAE (Burgess et al. 2018, Eq. 8): each KL
  term becomes ``gamma * |KL - C(step)|``, C interpolated from c_min to
  c_max over n_steps."""

  def __init__(self,
               gamma: float = 10.0,
               c_min: float = 0.01,
               c_max: float = 25.0,
               n_steps: int = 10000,
               interpolation: str = "linear",
               **kwargs):
    super().__init__(**kwargs)
    self.gamma = float(gamma)
    self.capacity = interp.get(interpolation)(vmin=float(c_min),
                                              vmax=float(c_max),
                                              steps=int(n_steps))

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    llk, kl, aux = super().elbo_components(params, batch, rng, step,
                                           training=training,
                                           mutables=mutables)
    c = self.capacity(step)
    kl = {k: self.gamma * torch.abs(v - c) for k, v in kl.items()}
    return llk, kl, aux
