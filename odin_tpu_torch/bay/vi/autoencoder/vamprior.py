"""VampriorVAE of the port (PyTorch port of
``odin_tpu/bay/vi/autoencoder/vamprior.py``; Tomczak & Welling 2018): the
prior ``p(z) = 1/K sum_k q(z | u_k)`` at learned pseudo-inputs u_k, a
'pseudo_inputs' partition trained in the VAE's step."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from odin_tpu_torch.bay.vi.autoencoder.beta_vae import BetaVAE
from odin_tpu_torch.training.core import TrainStep, as_noise

__all__ = ["VampriorVAE"]


class _PseudoInputs(nn.Module):
  """K learnable pseudo-inputs, drawn from N(0, 0.01^2) (flax's
  ``normal(0.01)``), kept in the data's range by a sigmoid."""

  def __init__(self, n_components: int, input_shape: Tuple[int, ...]):
    super().__init__()
    self.n_components = int(n_components)
    self.input_shape = tuple(input_shape)

  def build(self, in_shape=None, generator=None):
    shape = (self.n_components,) + self.input_shape
    self.pseudo_inputs = nn.Parameter(
        0.01 * torch.randn(shape, generator=generator))
    return shape

  def forward(self):
    return torch.sigmoid(self.pseudo_inputs)


class VampriorVAE(BetaVAE):
  """A VAE with a VampPrior: the latent KL is the Monte-Carlo estimate
  against the mixture of posteriors at the pseudo-inputs."""

  def __init__(self, n_components: int = 50, **kwargs):
    self.n_components = int(n_components)
    self._pseudo: Optional[_PseudoInputs] = None
    super().__init__(**kwargs)

  def extra_networks(self):
    if self.input_shape is None:
      raise ValueError("VampriorVAE needs the input shape to build")
    self._pseudo = _PseudoInputs(self.n_components, self.input_shape)
    return {"pseudo_inputs": (self._pseudo, None)}

  def train_steps(self):
    return [TrainStep(loss_fn=self._vae_loss,
                      partitions=("vae", "pseudo_inputs"), name="vae")]

  def _log_vamp_prior(self, params, z, training, mutables, noise):
    """log p(z) = logsumexp_k log q(z | u_k) - log K, z (B, zdim)."""
    u = self._apply_module(params, "pseudo_inputs", training=training)
    q_u = self._apply(params, "encode", u, training, mutables, noise)
    lp = q_u.log_prob(z[:, None, :])  # (B, K)
    return torch.logsumexp(lp, dim=-1) - math.log(self.n_components)

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y = self._split_inputs(batch)
    noise = as_noise(rng)
    qz = self._apply(params, "encode", x, training, mutables, noise)
    z = qz.sample_from(noise)
    px = self._apply(params, "decode", z, training, mutables, noise)
    llk = {"llk_image": px.log_prob(x)}
    log_pz = self._log_vamp_prior(params, z.reshape(-1, self.zdim), training,
                                  mutables, noise)
    beta = self._schedule(self.beta, step)
    kl = {"kl_latents": beta * (qz.log_prob(z) - log_pz)}
    return llk, kl, dict(qz=qz, px=px, z=z, x=x, y=y)
