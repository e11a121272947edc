"""VQ-VAE of the port (PyTorch port of
``odin_tpu/bay/vi/autoencoder/vq_vae.py``): ``VectorQuantizer``, the
codebook head, and ``VQVAE``.

The codebook is a param trained by the codebook loss, or with ``ema=True``
three buffers (flax's 'vq_stats' collection: ``codebook``, ``counts``,
``means``) that the training step moves by exponential moving averages;
the new values go through ``record_update`` into the state's mutables, so
a CUDA graph replay advances them as an eager step does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from odin_tpu_torch.bay.distributions import VectorQuantized
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    VariationalAutoencoder,
)
from odin_tpu_torch.networks.base import Dense, layer_noise, record_update
from odin_tpu_torch.training.core import as_noise

__all__ = ["VectorQuantizer", "VQVAE"]


class VectorQuantizer(nn.Module):
  """Project to `code_dim` (flax's ``projection`` Dense), snap every
  position to the nearest of `n_codes` codebook entries, and return a
  ``VectorQuantized``.  Inputs may have any leading dims: a flat bottleneck
  (B, D) or a feature map (B, H, W, C), each position quantized against
  the shared codebook, the EMA statistics pooled over all of them.

  ``restart_dead=True``: after each EMA update, codes whose EMA usage fell
  below ``dead_frac`` of the uniform share are re-seeded with encoder
  outputs of the batch, drawn from the step's noise (``layer_noise``)."""

  def __init__(self, n_codes: int = 64, code_dim: int = 32,
               commitment_weight: float = 0.25, ema: bool = False,
               ema_decay: float = 0.99, restart_dead: bool = False,
               dead_frac: float = 0.03, name: str = "latents"):
    super().__init__()
    self.n_codes, self.code_dim = int(n_codes), int(code_dim)
    self.commitment_weight = float(commitment_weight)
    self.ema, self.ema_decay = bool(ema), float(ema_decay)
    self.restart_dead, self.dead_frac = bool(restart_dead), float(dead_frac)
    self.name = name
    if self.ema:
      self.collection = "vq_stats"
    self.projection = Dense(self.code_dim, bare=True)

  @property
  def event_shape(self):
    return (self.code_dim,)

  @property
  def prior(self):
    return None

  def build(self, in_shape, generator=None):
    self.projection.build(in_shape, generator)
    # flax's variance_scaling(1.0, 'fan_in', 'uniform'); fan_in = n_codes
    limit = math.sqrt(3.0 / self.n_codes)
    cb = (2.0 * torch.rand((self.n_codes, self.code_dim),
                           generator=generator) - 1.0) * limit
    if self.ema:
      self.register_buffer("codebook", cb)
      # counts start at 1: the codebook stays at its start until real
      # assignments accumulate
      self.register_buffer("counts", torch.ones(self.n_codes))
      self.register_buffer("means", cb.clone())
    else:
      self.codebook = nn.Parameter(cb)
    return tuple(in_shape[:-1]) + self.event_shape  # a map stays a map

  def forward(self, h) -> VectorQuantized:
    h = self.projection(h)
    codebook = self.codebook
    d = (torch.sum(h * h, -1, keepdim=True) - 2.0 * h @ codebook.T +
         torch.sum(codebook * codebook, -1))
    indices = torch.argmin(d, dim=-1)
    codes = codebook[indices]
    if self.ema and self.training:
      self._ema_update(h.detach().reshape(-1, self.code_dim), indices)
    return VectorQuantized(codes=codes, inputs=h, indices=indices,
                           commitment_weight=self.commitment_weight)

  def _ema_update(self, hs, indices):
    decay, k = self.ema_decay, self.n_codes
    onehot = F.one_hot(indices.reshape(-1), k).to(hs.dtype)
    counts = decay * self.counts + (1 - decay) * torch.sum(onehot, dim=0)
    means = decay * self.means + (1 - decay) * (onehot.T @ hs)
    # Laplace smoothing, so that an empty cluster divides by no zero
    n = torch.sum(counts)
    smoothed = (counts + 1e-5) / (n + k * 1e-5) * n
    codebook = means / smoothed[:, None]
    if self.restart_dead:
      dead = counts < self.dead_frac * (n / k)
      noise = layer_noise()
      if noise is None:
        raise RuntimeError("restart_dead draws from the step's noise: call "
                           "the quantizer through the model in training "
                           "mode")
      rows = noise.randint(0, hs.shape[0], (k,), hs.device)
      seeds = hs[rows]
      codebook = torch.where(dead[:, None], seeds, codebook)
      counts = torch.where(dead, torch.ones_like(counts), counts)
      means = torch.where(dead[:, None], seeds, means)
    record_update(self, "counts", counts)
    record_update(self, "means", means)
    record_update(self, "codebook", codebook)


def _per_sample(v):
  """Spatial codes: the per-position losses summed over H, W -> (B,)."""
  return torch.sum(v, dim=tuple(range(1, v.ndim))) if v.ndim > 1 else v


class VQVAE(VariationalAutoencoder):
  """VQ-VAE (van den Oord et al. 2017): the commitment (and, without EMA,
  codebook) losses in the KL slot; the decoder reads the straight-through
  codes.  ``spatial=True`` declares an encoder that emits a feature map
  (``vq_dsprites_networks``): each position is quantized, and ``decode``
  takes the code map as it is."""

  def __init__(self,
               n_codes: int = 64,
               code_dim: Optional[int] = None,
               commitment_weight: float = 0.25,
               ema: bool = False,
               ema_decay: float = 0.99,
               restart_dead: bool = False,
               dead_frac: float = 0.03,
               spatial: bool = False,
               latents=None,
               **kwargs):
    if code_dim is None:
      code_dim = getattr(latents, "event_size", None) or 32
    vq = VectorQuantizer(n_codes=int(n_codes), code_dim=int(code_dim),
                         commitment_weight=float(commitment_weight),
                         ema=bool(ema), ema_decay=float(ema_decay),
                         restart_dead=bool(restart_dead),
                         dead_frac=float(dead_frac))
    self.spatial = bool(spatial)
    kwargs.pop("analytic", None)
    super().__init__(latents=vq, analytic=False, **kwargs)

  @property
  def latents_prior(self):
    return None  # uniform over the codes, constant in the params

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y = self._split_inputs(batch)
    noise = as_noise(rng)
    vq = self._apply(params, "encode", x, training, mutables, noise)
    z = vq.mean()  # the straight-through codes
    px = self._apply(params, "decode", z, training, mutables, noise)
    llk = {"llk_image": px.log_prob(x)}
    kl = {"commitment": _per_sample(vq.commitment_weight *
                                    vq.commitment_loss())}
    if not self.core.latents.ema:  # with EMA the codebook moves itself
      kl["codebook"] = _per_sample(vq.codebook_loss())
    return llk, kl, dict(qz=vq, px=px, z=z, x=x, y=y)

  def _vae_loss(self, params, batch, rng, step, mutables):
    llk, kl, aux = self.elbo_components(params, batch, rng, step,
                                        training=True, mutables=mutables)
    loss = -torch.mean(self.elbo(llk, kl))
    metrics = {k: torch.mean(v) for k, v in {**llk, **kl}.items()}
    # the codebook's usage perplexity, pooled over every quantized position
    onehot = F.one_hot(aux["qz"].indices.reshape(-1),
                       self.core.latents.n_codes).to(torch.float32)
    avg = torch.mean(onehot, dim=0)
    metrics["perplexity"] = torch.exp(-torch.sum(avg * torch.log(avg + 1e-10)))
    return loss, (metrics, mutables)

  def decode(self, z, params=None):
    """Spatial code maps (B, H, W, D) go to the decoder as they are (the
    base class would take the leading dims for sample dims)."""
    if self.spatial:
      return self._apply(params or self._params_of(), "decode",
                         self._tensor(z), mutables=self._mutables())
    return super().decode(z, params)

  def encode_codes(self, x) -> torch.Tensor:
    """x -> the integer codebook indices (the discrete latents)."""
    return self.encode(x).indices

  def decode_codes(self, indices):
    """Integer code indices -> p(x | codebook[indices])."""
    key = "latents.codebook"
    codebook = (self.state.mutables["vae"][key] if self.core.latents.ema
                else self._params_of()["vae"][key])
    return self.decode(codebook[torch.as_tensor(indices,
                                                device=codebook.device)])
