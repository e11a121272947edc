"""Cycle-consistent VAE of the port on same-class pairs (PyTorch port of
``odin_tpu/bay/vi/autoencoder/cycle_vae.py``: ``CycleCore`` :45-78 and
``CycleConsistentVAE`` :81-142; Jha et al. 2018, arXiv:1804.10469).

The latent splits into a specified part s (a Dense head, ``specified``)
and an unspecified Gaussian part z.  Forward cycle: a pair (x1, x2) of
one class is reconstructed from its swapped specified codes, (s2, z1) and
(s1, z2).  Reverse cycle: one prior draw z' decoded with both specified
codes and encoded again must give the same style (``cycle_consistency``,
the L1 distance of the two posterior means, times `cycle_weight`).
Batches are ``(x1, x2)`` or one (B, 2, ...) tensor; a single unpaired
tensor falls back to the plain ELBO.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from odin_tpu_torch.bay.helpers import kl_divergence
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    VariationalAutoencoder,
)
from odin_tpu_torch.networks.base import Dense
from odin_tpu_torch.training.core import as_noise

__all__ = ["CycleConsistentVAE"]


class CycleCore(nn.Module):
  """encoder -> (s, qz); decoder(concat[s, z]) -> px."""

  def __init__(self, encoder: nn.Module, decoder: nn.Module,
               latents: nn.Module, observation: nn.Module, sdim: int):
    super().__init__()
    self.encoder = encoder
    self.decoder = decoder
    self.latents = latents
    self.observation = observation
    self.sdim = int(sdim)
    self.specified = Dense(self.sdim, bare=True)

  def build(self, input_shape, generator=None):
    h = self.encoder.build(tuple(input_shape), generator)
    self.specified.build(h, generator)
    z = self.latents.build(h, generator)
    hd = self.decoder.build((self.sdim + int(z[-1]),), generator)
    self.observation.build(hd, generator)

  def encode_full(self, x):
    h = self.encoder(x)
    return self.specified(h), self.latents(h)

  def encode(self, x):
    return self.encode_full(x)[1]

  def decode_pair(self, s, z):
    return self.observation(self.decoder(torch.cat([s, z], dim=-1)))

  def decode(self, z):
    """The decode of a neutral (zero) specified code."""
    s = torch.zeros(tuple(z.shape[:-1]) + (self.sdim,), dtype=z.dtype,
                    device=z.device)
    return self.decode_pair(s, z)

  def forward(self, *args, method: Optional[str] = None):
    if method is not None:
      return getattr(self, method)(*args)
    s, qz = self.encode_full(args[0])
    return self.decode_pair(s, qz.mean()), qz


class CycleConsistentVAE(VariationalAutoencoder):
  """Jha et al. 2018 on the networks of ``get_networks`` (the decoder
  reads ``sdim + zdim`` inputs)."""

  def __init__(self, sdim: int = 16, cycle_weight: float = 1.0, **kwargs):
    self.sdim = int(sdim)
    self.cycle_weight = float(cycle_weight)
    super().__init__(**kwargs)

  def _build_core(self) -> nn.Module:
    return CycleCore(self.encoder_net, self.decoder_net, self.latents_head,
                     self.observation_head, self.sdim)

  def _split_pair(self, batch):
    if isinstance(batch, (tuple, list)):
      x1 = batch[0]
      x2 = batch[1] if len(batch) > 1 else None
      if x2 is not None and tuple(x2.shape) != tuple(x1.shape):
        x2 = None
      return x1, x2
    x = batch
    if self.input_shape is not None and \
        x.ndim == len(self.input_shape) + 2 and x.shape[1] == 2:
      return x[:, 0], x[:, 1]
    return x, None

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x1, x2 = self._split_pair(batch)
    if x2 is None:  # unpaired: the self-reconstruction ELBO
      return super().elbo_components(params, x1, rng, step,
                                     training=training, mutables=mutables)
    noise = as_noise(rng)
    n = x1.shape[0]
    x12 = torch.cat([x1, x2], 0)
    s, qz = self._core(params, "encode_full", x12, training=training,
                       mutables=mutables, noise=noise)
    z = qz.sample_from(noise)
    s1, s2 = s[:n], s[n:]
    # forward cycle: the specified codes swapped within the pair
    px = self._core(params, "decode_pair", torch.cat([s2, s1], 0), z,
                    training=training, mutables=mutables, noise=noise)
    lp = px.log_prob(x12)
    llk = {"llk_observation": 0.5 * (lp[:n] + lp[n:])}
    prior = self._prior_on(z.device)
    kl_z = kl_divergence(qz, prior, analytic=self.analytic,
                         q_sample=z if not self.analytic else None,
                         reverse=self.reverse, free_bits=self.free_bits)
    kl = {"kl_latents": 0.5 * (kl_z[:n] + kl_z[n:])}
    # reverse cycle: one prior style through both specified codes must
    # encode back to the same style
    z_prior = prior.sample_from(noise, (n,))
    px_gen = self._core(params, "decode_pair", s, torch.cat([z_prior,
                                                             z_prior], 0),
                        training=training, mutables=mutables, noise=noise)
    x_gen = px_gen.mean().reshape((2 * n,) + tuple(x1.shape[1:]))
    m = self._core(params, "encode", x_gen, training=training,
                   mutables=mutables, noise=noise).mean()
    kl["cycle_consistency"] = self.cycle_weight * torch.sum(
        torch.abs(m[:n] - m[n:]), dim=-1)
    return llk, kl, dict(qz=qz, px=px, z=z[:n], x=x1, y=None, s=s1)
