"""Multimodal mixture-of-experts VAE of the port (MMVAE, Shi et al. 2019;
PyTorch port of ``odin_tpu/bay/vi/autoencoder/moe_vae.py``: ``MoECore``
:46-78 and ``MoeVAE`` :81-180).

Each modality m has its encoder, its latent head ``latents{m}`` (flax's
``latent_heads_{m}``) into one shared latent space, its decoder and its
observation head.  The joint posterior is the mixture of the experts,
``q(z | x_1..M) = 1/M sum_m q_m(z | x_m)``; the ELBO is estimated by
stratified sampling: a draw ``z_m ~ q_m`` of each expert scores every
modality's likelihood, and the Monte-Carlo KL takes the mixture's density
(an (M, M, B) logsumexp).  Batches are M-tuples of per-modality tensors;
``cross_generate`` encodes one modality and decodes another.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch
from torch import nn

from odin_tpu_torch.bay.layers.dense_distribution import DistributionDense
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    VariationalAutoencoder,
    _as_head,
)
from odin_tpu_torch.training.core import as_noise

__all__ = ["MoeVAE"]


class MoECore(nn.Module):
  """Per-modality encoders, latent heads, decoders and observation heads
  (``encoders.<m>``, ``latent_heads.<m>``, ``decoders.<m>``,
  ``observations.<m>``) over one shared latent space."""

  def __init__(self, encoders, decoders, latent_heads, observations):
    super().__init__()
    self.encoders = nn.ModuleList(encoders)
    self.decoders = nn.ModuleList(decoders)
    self.latent_heads = nn.ModuleList(latent_heads)
    self.observations = nn.ModuleList(observations)

  @property
  def latents(self) -> nn.Module:
    return self.latent_heads[0]

  @property
  def observation(self) -> nn.Module:
    return self.observations[0]

  def build(self, input_shapes, generator=None):
    for m, shape in enumerate(input_shapes):
      h = self.encoders[m].build(tuple(shape), generator)
      z = self.latent_heads[m].build(h, generator)
      self.observations[m].build(self.decoders[m].build(z, generator),
                                 generator)

  def encode_mod(self, x, m: int):
    return self.latent_heads[m](self.encoders[m](x))

  def decode_mod(self, z, m: int):
    return self.observations[m](self.decoders[m](z))

  def encode(self, x):
    """Modality 0's posterior."""
    return self.encode_mod(x, 0)

  def decode(self, z):
    return self.decode_mod(z, 0)

  def forward(self, *args, method: Optional[str] = None):
    if method is not None:
      return getattr(self, method)(*args)
    xs = args[0]
    if not isinstance(xs, (tuple, list)):
      xs = (xs,) * len(self.encoders)
    qs = [self.encode_mod(x, m) for m, x in enumerate(xs)]
    return [self.decode_mod(q.mean(), m) for m, q in enumerate(qs)], qs


class MoeVAE(VariationalAutoencoder):
  """MMVAE: `encoders`, `decoders` and `observations` (RVconfs or heads)
  one per modality, `latents` the shared latent's RVconf (each modality
  gets its own projection into it); ``build(input_shapes=[...])``."""

  def __init__(self, encoders: Sequence[nn.Module],
               decoders: Sequence[nn.Module], observations: Sequence[Any],
               latents: Any = None,
               input_shapes: Optional[Sequence[Tuple[int, ...]]] = None,
               **kwargs):
    if latents is None:
      latents = RVconf(16, "mvndiag", projection=True, name="latents")
    self.n_modalities = len(encoders)
    if len(decoders) != self.n_modalities or \
        len(observations) != self.n_modalities:
      raise ValueError("MoeVAE needs one encoder, decoder and observation "
                       "per modality")
    self._moe_encoders = tuple(encoders)
    self._moe_decoders = tuple(decoders)
    self._moe_observations = tuple(
        _as_head(o, f"observation{m}") for m, o in enumerate(observations))
    self.input_shapes = (tuple(tuple(s) for s in input_shapes)
                         if input_shapes is not None else None)
    if self.input_shapes is not None:
      kwargs.setdefault("input_shape", self.input_shapes[0])
    super().__init__(encoder=encoders[0], decoder=decoders[0],
                     latents=latents, observation=observations[0], **kwargs)

  def _build_core(self) -> nn.Module:
    head = self.latents_head
    heads = [DistributionDense(head.event_shape, head.posterior,
                               head.posterior_kwargs, name=f"latents{m}")
             for m in range(self.n_modalities)]
    return MoECore(self._moe_encoders, self._moe_decoders, heads,
                   self._moe_observations)

  def build(self, input_shapes=None, seed: int = 1, device="cuda"):
    if input_shapes is not None:
      self.input_shapes = tuple(tuple(s) for s in input_shapes)
    if self.input_shapes is None:
      raise ValueError("input_shapes must be provided")
    super().build(input_shape=self.input_shapes, seed=seed, device=device)
    self.input_shape = tuple(self.input_shapes[0])
    return self

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    xs = batch if isinstance(batch, (tuple, list)) else (batch,)
    M = self.n_modalities
    if len(xs) != M:
      raise ValueError(f"expected {M} modalities, got {len(xs)}")
    noise = as_noise(rng)
    qs = [self._core(params, "encode_mod", x, m, training=training,
                     mutables=mutables, noise=noise)
          for m, x in enumerate(xs)]
    zs = [q.sample_from(noise) for q in qs]  # stratified: one per expert
    llk = {}
    for n in range(M):  # every modality scored under every expert's draw
      tot = 0.0
      for m in range(M):
        px = self._core(params, "decode_mod", zs[m], n, training=training,
                        mutables=mutables, noise=noise)
        tot = tot + px.log_prob(xs[n])
      llk[f"llk_mod{n}"] = tot / M
    prior = self._prior_on(zs[0].device)
    kl_terms = []
    for m in range(M):  # MC KL against the mixture: log q(z_m) - log p(z_m)
      log_q = torch.logsumexp(torch.stack([q.log_prob(zs[m]) for q in qs], 0),
                              dim=0) - math.log(float(M))
      kl_terms.append(log_q - prior.log_prob(zs[m]))
    kl = {"kl_latents": sum(kl_terms) / M}
    return llk, kl, dict(qz=qs[0], px=None, z=zs[0], x=xs[0], y=None)

  @torch.no_grad()
  def cross_generate(self, x, from_mod: int = 0, to_mod: int = 1,
                     params=None, seed: int = 0):
    """Encode modality `from_mod`, decode its posterior mean into modality
    `to_mod`: the distribution."""
    params = params if params is not None else self._params_of()
    q = self._core(params, "encode_mod", self._tensor(x), from_mod,
                   mutables=self._mutables())
    return self._core(params, "decode_mod", q.mean(), to_mod,
                      mutables=self._mutables())
