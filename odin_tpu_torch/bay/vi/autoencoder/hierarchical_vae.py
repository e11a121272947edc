"""Hierarchical (ladder) VAEs of the port (PyTorch port of
``odin_tpu/bay/vi/autoencoder/hierarchical_vae.py``): the rungs
``BiConvLatents``, ``BiDenseLatents`` and ``ParallelLatents`` (:41-229),
the cores ``LadderCore``, ``UnetCore`` and ``PUnetCore`` (:232, :366,
:515), and ``HierarchicalVAE`` (alias ``LadderVAE``), ``UnetVAE``,
``PUnetVAE`` and ``VeryDeepVAE`` (:276, :441, :574, :631).

The ladder is explicit, as in the JAX package: the encoder returns every
layer's output (``SequentialNetwork(return_hidden=True)``), and the core
walks the decoder's layers, inserting after each configured layer index a
rung whose prior reads the decoder state and whose posterior also reads
the paired encoder state (``hierarchy``: ``decoder_layer``,
``encoder_layer``, ``channels``, ``filters``, ``kernel_size``,
``strides`` and an optional ``latents`` kind).  Without encoder states
(generation) a rung samples from its prior.

A rung's and a skip's draws come from the ``Noise`` the model hands the
core (``networks.base.layer_noise``), in the JAX package's order: the rung
noise of each ``BiConvLatents`` call, which it draws in evaluation too; a
U-Net's per-sample skip gate, then each skip's dropout mask and noise.  A
Bernoulli mask is a uniform draw compared with the keep rate, as
``jax.random.bernoulli`` forms it.  Submodules are named as flax names
them (``ladder_{i}`` with ``prior_conv``, ``post_conv_d``,
``post_conv_e``, ``merge_deconv``; ``skip_{i}``; ``ladder_q{i}`` and
``ladder_p{i}``), each a bare flax layer, so that ``weights`` maps them by
path.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from odin_tpu_torch.backend.interpolation import linear
from odin_tpu_torch.bay.distributions import Distribution, Independent, Normal
from odin_tpu_torch.bay.helpers import kl_divergence
from odin_tpu_torch.bay.vi.autoencoder.beta_vae import BetaVAE
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    VAECore,
    VariationalAutoencoder,
)
from odin_tpu_torch.networks.base import Conv, ConvTranspose, Dense, layer_noise
from odin_tpu_torch.training.core import Noise, as_noise

__all__ = ["BiConvLatents", "BiDenseLatents", "ParallelLatents",
           "LadderCore", "HierarchicalVAE", "LadderVAE",
           "UnetCore", "UnetVAE", "PUnetCore", "PUnetVAE", "VeryDeepVAE"]

Shape = Tuple[int, ...]


def _loc_scale(params: torch.Tensor):
  """(loc, softplus(raw) + 1e-5) of the two halves of the last axis."""
  loc, raw = torch.chunk(params, 2, dim=-1)
  return loc, F.softplus(raw) + 1e-5


def _draw_noise():
  noise = layer_noise()
  if noise is None:
    raise RuntimeError("a ladder rung or a U-Net skip draws from the Noise "
                       "its model hands the core; call it through the model")
  return noise


def _rung_sample(src: Independent, shape, sample: bool) -> torch.Tensor:
  """z of a rung: ``loc + scale * eps`` (eps drawn at the prior's shape),
  or the mean."""
  if not sample:
    return src.mean()
  base = src.distribution
  eps = _draw_noise().normal(shape, base.loc.dtype, base.loc.device)
  return base.loc + base.scale * eps


def _flat(h: torch.Tensor) -> torch.Tensor:
  return h.reshape(h.shape[0], -1)


class BiConvLatents(nn.Module):
  """One ladder rung (JAX ``hierarchical_vae.py:41-97``): the prior
  p(z_i | z_>i) is a conv of the decoder state d, the posterior
  q(z_i | ...) the sum of a conv of d and one of the encoder state e; z_i
  goes back through a transposed conv, cropped to d's grid and added."""

  def __init__(self, filters: int = 16, kernel_size: int = 8,
               strides: int = 4, merge_channels: int = 64):
    super().__init__()
    self.filters = int(filters)
    k, s = int(kernel_size), int(strides)
    self.prior_conv = Conv(2 * self.filters, k, s, bare=True)
    self.post_conv_d = Conv(2 * self.filters, k, s, bare=True)
    self.post_conv_e = Conv(2 * self.filters, k, s, bare=True)
    self.merge_deconv = ConvTranspose(int(merge_channels), k, s, bare=True)

  def build(self, d_shape: Shape, e_shape: Shape, generator=None) -> Shape:
    z_shape = self.prior_conv.build(d_shape, generator)
    self.post_conv_d.build(d_shape, generator)
    self.post_conv_e.build(e_shape, generator)
    self.merge_deconv.build(z_shape[:-1] + (self.filters,), generator)
    return tuple(d_shape)

  def prior_params(self, d):
    return _loc_scale(self.prior_conv(d))

  def posterior_params(self, d, e):
    return _loc_scale(self.post_conv_d(d) + self.post_conv_e(e))

  def merge(self, d, z):
    up = self.merge_deconv(z)
    return d + up[:, :d.shape[1], :d.shape[2], :]  # NHWC crop to d's grid

  def forward(self, d, e=None, z=None, sample: bool = True):
    """(new d, qz_i, pz_i, z_i); with e None, z_i comes from the prior
    (generation)."""
    p_loc, p_scale = self.prior_params(d)
    pz = Independent(Normal(p_loc, p_scale), 3)
    qz = None
    if e is not None:
      qz = Independent(Normal(*self.posterior_params(d, e)), 3)
    if z is None:
      z = _rung_sample(qz if qz is not None else pz, p_loc.shape, sample)
    return self.merge(d, z), qz, pz, z


class BiDenseLatents(nn.Module):
  """The rung with Dense heads on the flattened states (JAX
  ``hierarchical_vae.py:100-154``); its merge is broadcast back onto a
  spatial state, cut or zero-padded to the state's channels."""

  def __init__(self, units: int = 16, merge_units: int = 64):
    super().__init__()
    self.units = int(units)
    self.prior_dense = Dense(2 * self.units, bare=True)
    self.post_dense_d = Dense(2 * self.units, bare=True)
    self.post_dense_e = Dense(2 * self.units, bare=True)
    self.merge_dense = Dense(int(merge_units), bare=True)

  def build(self, d_shape: Shape, e_shape: Shape, generator=None) -> Shape:
    flat = lambda s: (int(np.prod(s)),)
    self.prior_dense.build(flat(d_shape), generator)
    self.post_dense_d.build(flat(d_shape), generator)
    self.post_dense_e.build(flat(e_shape), generator)
    self.merge_dense.build((self.units,), generator)
    return tuple(d_shape)

  def prior_params(self, d):
    return _loc_scale(self.prior_dense(_flat(d)))

  def posterior_params(self, d, e):
    return _loc_scale(self.post_dense_d(_flat(d)) +
                      self.post_dense_e(_flat(e)))

  def merge(self, d, z):
    up = self.merge_dense(z)
    if d.ndim > 2:
      up = up.reshape((up.shape[0],) + (1,) * (d.ndim - 2) + (-1,))
      c = d.shape[-1]
      up = up[..., :c] if up.shape[-1] >= c else \
          F.pad(up, (0, c - up.shape[-1]))
      return d + up.expand(d.shape)
    return d + up[..., :d.shape[-1]]

  def forward(self, d, e=None, z=None, sample: bool = True):
    p_loc, p_scale = self.prior_params(d)
    pz = Independent(Normal(p_loc, p_scale), 1)
    qz = None
    if e is not None:
      qz = Independent(Normal(*self.posterior_params(d, e)), 1)
    if z is None:
      z = _rung_sample(qz if qz is not None else pz, p_loc.shape, sample)
    return self.merge(d, z), qz, pz, z


class ParallelLatents(nn.Module):
  """A parallel latent group (JAX ``hierarchical_vae.py:157-209``, Zhao et
  al. 2017): the posterior reads only the encoder state (cropped to the
  prior's grid), the prior the decoder state; the merge adds the
  transposed conv of z_i to ``residual_coef`` times d."""

  def __init__(self, filters: int = 16, kernel_size: int = 8,
               strides: int = 4, merge_channels: int = 64,
               residual_coef: float = 1.0):
    super().__init__()
    self.filters = int(filters)
    self.residual_coef = float(residual_coef)
    k, s = int(kernel_size), int(strides)
    self.prior_conv = Conv(2 * self.filters, k, s, bare=True)
    self.post_conv_e = Conv(2 * self.filters, k, s, bare=True)
    self.merge_deconv = ConvTranspose(int(merge_channels), k, s, bare=True)

  def build(self, d_shape: Shape, e_shape: Shape, generator=None) -> Shape:
    z_shape = self.prior_conv.build(d_shape, generator)
    self.post_conv_e.build(e_shape, generator)
    self.merge_deconv.build(z_shape[:-1] + (self.filters,), generator)
    return tuple(d_shape)

  def prior_params(self, d):
    return _loc_scale(self.prior_conv(d))

  def posterior_params(self, e):
    return _loc_scale(self.post_conv_e(e))

  def forward(self, d, e=None, z=None, sample: bool = True):
    p_loc, p_scale = self.prior_params(d)
    pz = Independent(Normal(p_loc, p_scale), 3)
    qz = None
    if e is not None:
      h, w = p_loc.shape[1], p_loc.shape[2]
      q_loc, q_scale = self.posterior_params(e)
      qz = Independent(Normal(q_loc[:, :h, :w, :], q_scale[:, :h, :w, :]), 3)
    if z is None:
      z = _rung_sample(qz if qz is not None else pz, p_loc.shape, sample)
    up = self.merge_deconv(z)[:, :d.shape[1], :d.shape[2], :]
    return self.residual_coef * d + up, qz, pz, z


def _make_rung(h: Dict[str, Any]) -> nn.Module:
  """The rung of one ``hierarchy`` entry (JAX ``_make_rung``, :212-229)."""
  kind = str(h.get("latents", "biconv")).lower()
  if kind in ("bidense", "dense"):
    return BiDenseLatents(units=h.get("filters", 16),
                          merge_units=h.get("channels", 64))
  if kind == "parallel":
    return ParallelLatents(filters=h["filters"], kernel_size=h["kernel_size"],
                           strides=h["strides"],
                           merge_channels=h.get("channels", 64),
                           residual_coef=float(h.get("residual_coef", 1.0)))
  return BiConvLatents(filters=h["filters"], kernel_size=h["kernel_size"],
                       strides=h["strides"],
                       merge_channels=h.get("channels", 64))


class _HierarchyCore(VAECore):
  """A core whose encoder hands every layer's output to the decoder walk:
  ``build`` records the encoder's hidden shapes and calls
  ``_build_at(layer index, decoder shape, encoder shapes, generator)``
  after each configured decoder layer, and ``encode`` returns (qz,
  hiddens)."""

  def __init__(self, encoder, decoder, latents, observation,
               hierarchy: Sequence[Dict[str, Any]] = (), labels=None):
    super().__init__(encoder, decoder, latents, observation, labels,
                     "latents")
    self.hierarchy = tuple(dict(h) for h in hierarchy)
    self._spec = {h["decoder_layer"]: (i, h)
                  for i, h in enumerate(self.hierarchy)}

  def build(self, input_shape, generator=None):
    shape, hidden = tuple(input_shape), []
    for layer in self.encoder.layers:
      shape = layer.build(shape, generator)
      hidden.append(shape)
    z = self.latents.build(shape, generator)
    d = z
    for li, layer in enumerate(self.decoder.layers):
      d = layer.build(d, generator)
      if li in self._spec:
        self._build_at(li, d, hidden, generator)
    self.observation.build(d, generator)
    if self.labels is not None:
      self.labels.build(z, generator)

  def _build_at(self, li: int, d_shape: Shape, hidden: Sequence[Shape],
                generator):
    raise NotImplementedError

  def encode(self, x):
    h, hiddens = self.encoder(x, return_hidden=True)
    return self.latents(h), hiddens

  def forward(self, *args, method: Optional[str] = None):
    """As ``VAECore.forward``; without a method, x -> (px, qz) through the
    posterior mean and the encoder's states."""
    if method is not None:
      return getattr(self, method)(*args)
    qz, hiddens = self.encode(args[0])
    px, _ = self.decode(qz.mean(), hiddens)
    return px, qz


class LadderCore(_HierarchyCore):
  """The ladder VAE's core (JAX ``LadderCore``): a rung ``ladder_{i}``
  after the decoder layer of each ``hierarchy`` entry."""

  def __init__(self, encoder, decoder, latents, observation,
               hierarchy: Sequence[Dict[str, Any]] = (), labels=None):
    super().__init__(encoder, decoder, latents, observation, hierarchy,
                     labels)
    for i, h in enumerate(self.hierarchy):
      self.add_module(f"ladder_{i}", _make_rung(h))

  def _build_at(self, li, d_shape, hidden, generator):
    ri, h = self._spec[li]
    getattr(self, f"ladder_{ri}").build(d_shape, hidden[h["encoder_layer"]],
                                        generator)

  def decode(self, z, hiddens=None):
    """(px, [(qz_i, pz_i) of each rung]); hiddens None -> generation, the
    rungs sampled from their priors."""
    d, dists = z, []
    for li, layer in enumerate(self.decoder.layers):
      d = layer(d)
      if li in self._spec:
        ri, h = self._spec[li]
        e = hiddens[h["encoder_layer"]] if hiddens is not None else None
        d, qz_i, pz_i, _ = getattr(self, f"ladder_{ri}")(d, e)
        dists.append((qz_i, pz_i))
    return self.observation(d), dists


def _free_bits_rung(kl_i: torch.Tensor, free_bits: Optional[float],
                    event_shape) -> torch.Tensor:
  """Free bits of a rung, scaled by its event size, on the per-sample
  total."""
  if free_bits is None:
    return kl_i
  return torch.clamp(kl_i, min=free_bits * float(np.prod(event_shape)))


class _PosteriorPathVAE(VariationalAutoencoder):
  """``encode``/``decode`` of a core whose methods return a pair, and
  ``reconstruct`` through the posterior path (the decoder given the
  encoder's states), each drawing from a generator seeded `seed`, as the
  JAX package keys them."""

  def _noise(self, seed: int) -> Noise:
    return Noise(self._generator(seed))

  def encode(self, x, params: Optional[Dict] = None,
             seed: int = 0) -> Distribution:
    qz, _ = self._core(params or self._params_of(), "encode",
                       self._tensor(x), mutables=self._mutables(),
                       noise=self._noise(seed))
    return qz

  def decode(self, z, params: Optional[Dict] = None,
             seed: int = 0) -> Distribution:
    """Generation mode: no encoder states."""
    px, _ = self._core(params or self._params_of(), "decode",
                       self._tensor(z), None, mutables=self._mutables(),
                       noise=self._noise(seed))
    return px

  def reconstruct(self, x, params: Optional[Dict] = None, seed: int = 0
                  ) -> Tuple[Distribution, Distribution]:
    """x -> (qz, px): decode the posterior mean WITH the encoder's states,
    matching the training objective (a generation-mode decode discards
    the rungs' posteriors or the skips)."""
    params = params or self._params_of()
    noise, mut = self._noise(seed), self._mutables()
    qz, hiddens = self._core(params, "encode", self._tensor(x),
                             mutables=mut, noise=noise)
    px, _ = self._core(params, "decode", qz.mean(), hiddens, mutables=mut,
                       noise=noise)
    return qz, px

  def _encode_sample(self, params, x, noise, training, mutables):
    qz, hidden = self._core(params, "encode", x, training=training,
                            mutables=mutables, noise=noise)
    return qz, hidden, qz.sample_from(noise)

  def _kl_latents(self, qz, z):
    return kl_divergence(qz, self._prior_on(z.device), analytic=self.analytic,
                         q_sample=z, reverse=self.reverse,
                         free_bits=self.free_bits)


class HierarchicalVAE(_PosteriorPathVAE):
  """Ladder VAE (Sønderby et al. 2016; JAX ``hierarchical_vae.py:276-363``):
  the top latents and one KL term ``kl_ladder{i}`` per rung, the analytic
  KL of its posterior against its prior, each with free bits (0.25 by
  default) scaled by the rung's event size.  ``sample_observation`` samples
  ancestrally: the top latents from the prior, each rung from its
  conditional prior."""

  def __init__(self, free_bits: Optional[float] = 0.25, **kwargs):
    kwargs.setdefault("name", "hierarchicalvae")
    super().__init__(free_bits=free_bits, **kwargs)
    if not self.hierarchy:
      raise ValueError("HierarchicalVAE requires a non-empty `hierarchy` "
                       "spec (use get_networks(..., is_hierarchical=True))")

  def _build_core(self) -> nn.Module:
    return LadderCore(self.encoder_net, self.decoder_net, self.latents_head,
                      self.observation_head, self.hierarchy, self.labels_head)

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y = self._split_inputs(batch)
    noise = as_noise(rng)
    qz, hiddens, z = self._encode_sample(params, x, noise, training,
                                         mutables)
    px, dists = self._core(params, "decode", z, hiddens, training=training,
                           mutables=mutables, noise=noise)
    llk = {"llk_image": px.log_prob(x)}
    kl = {"kl_latents": self._kl_latents(qz, z)}
    for i, (qz_i, pz_i) in enumerate(dists):
      kl[f"kl_ladder{i}"] = _free_bits_rung(
          qz_i.kl_divergence(pz_i, analytic=True), self.free_bits,
          qz_i.event_shape)
    return llk, kl, dict(qz=qz, px=px, z=z, x=x, y=y, ladder=dists)

  def sample_observation(self, n: int = 1, seed: int = 0) -> Distribution:
    return self.decode(self.sample_prior(n, seed), seed=seed)


LadderVAE = HierarchicalVAE


class UnetCore(_HierarchyCore):
  """The U-Net core (JAX ``UnetCore``, :366-438): after each configured
  decoder layer, the encoder state, projected by a 1x1 conv ``skip_{i}``
  and cropped to the decoder's grid, is added to it.  In training, with
  `skip_sample_dropout` a whole sample sees no skip (one gate a sample,
  shared by every skip), `skip_dropout` drops skip units (rescaled by the
  keep rate) and `skip_noise` adds Gaussian noise."""

  def __init__(self, encoder, decoder, latents, observation,
               hierarchy: Sequence[Dict[str, Any]] = (),
               skip_dropout: float = 0.0, skip_noise: float = 0.0,
               skip_sample_dropout: float = 0.0, labels=None):
    super().__init__(encoder, decoder, latents, observation, hierarchy,
                     labels)
    self.skip_dropout = float(skip_dropout)
    self.skip_noise = float(skip_noise)
    self.skip_sample_dropout = float(skip_sample_dropout)
    for i, h in enumerate(self.hierarchy):
      self.add_module(f"skip_{i}", Conv(h.get("channels", 64), 1, 1,
                                        bare=True))

  def _build_at(self, li, d_shape, hidden, generator):
    ri, h = self._spec[li]
    getattr(self, f"skip_{ri}").build(hidden[h["encoder_layer"]], generator)

  def decode(self, z, hiddens=None):
    """(px, ()); hiddens None -> generation, no skips."""
    gate = None
    if self.skip_sample_dropout > 0 and self.training and \
        hiddens is not None:
      u = _draw_noise().uniform((z.shape[0], 1, 1, 1), z.dtype, z.device)
      gate = (u < 1.0 - self.skip_sample_dropout).to(z.dtype)
    d = z
    for li, layer in enumerate(self.decoder.layers):
      d = layer(d)
      if li in self._spec and hiddens is not None:
        ri, h = self._spec[li]
        e = getattr(self, f"skip_{ri}")(hiddens[h["encoder_layer"]])
        e = e[:, :d.shape[1], :d.shape[2], :]
        if self.skip_dropout > 0 and self.training:
          u = _draw_noise().uniform(e.shape, e.dtype, e.device)
          keep = (u < 1.0 - self.skip_dropout).to(e.dtype)
          e = e * keep / (1.0 - self.skip_dropout)
        if self.skip_noise > 0 and self.training:
          e = e + self.skip_noise * _draw_noise().normal(e.shape, e.dtype,
                                                         e.device)
        if gate is not None:
          e = e * gate
        d = d + e
    return self.observation(d), ()


class UnetVAE(_PosteriorPathVAE, BetaVAE):
  """U-Net VAE (JAX ``hierarchical_vae.py:441-512``): deterministic skips
  from the encoder to the decoder at each configured resolution and one
  stochastic bottleneck; beta 10 and free bits 2 by default.  ``decode``
  is the generation mode (no skips), ``reconstruct`` the posterior
  path."""

  def __init__(self, beta: float = 10.0, free_bits: Optional[float] = 2.0,
               skip_dropout: float = 0.0, skip_noise: float = 0.0,
               skip_sample_dropout: float = 0.0, **kwargs):
    self.skip_dropout = float(skip_dropout)
    self.skip_noise = float(skip_noise)
    self.skip_sample_dropout = float(skip_sample_dropout)
    kwargs.setdefault("name", "unetvae")
    super().__init__(beta=beta, free_bits=free_bits, **kwargs)
    if not self.hierarchy:
      raise ValueError("UnetVAE requires a `hierarchy` spec for its skip "
                       "map (use get_networks(..., is_hierarchical=True))")

  def _build_core(self) -> nn.Module:
    return UnetCore(self.encoder_net, self.decoder_net, self.latents_head,
                    self.observation_head, self.hierarchy,
                    skip_dropout=self.skip_dropout,
                    skip_noise=self.skip_noise,
                    skip_sample_dropout=self.skip_sample_dropout,
                    labels=self.labels_head)

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y = self._split_inputs(batch)
    noise = as_noise(rng)
    qz, hiddens, z = self._encode_sample(params, x, noise, training,
                                         mutables)
    px, _ = self._core(params, "decode", z, hiddens, training=training,
                       mutables=mutables, noise=noise)
    beta = self._schedule(self.beta, step)
    llk = {"llk_image": px.log_prob(x)}
    kl = {"kl_latents": beta * self._kl_latents(qz, z)}
    return llk, kl, dict(qz=qz, px=px, z=z, x=x, y=y)


class PUnetCore(_HierarchyCore):
  """The probabilistic U-Net core (JAX ``PUnetCore``, :515-571): per
  configured resolution a posterior head ``ladder_q{i}`` on the flattened
  encoder state and a prior head ``ladder_p{i}`` on the flattened decoder
  state, each a Dense diagonal Gaussian of `ladder_units`; their samples do
  not feed the decoder, they only regularise it through their KL."""

  def __init__(self, encoder, decoder, latents, observation,
               hierarchy: Sequence[Dict[str, Any]] = (),
               ladder_units: int = 16, labels=None):
    super().__init__(encoder, decoder, latents, observation, hierarchy,
                     labels)
    u = int(ladder_units)
    for i in range(len(self.hierarchy)):
      self.add_module(f"ladder_q{i}", Dense(2 * u, bare=True))
      self.add_module(f"ladder_p{i}", Dense(2 * u, bare=True))

  def _build_at(self, li, d_shape, hidden, generator):
    ri, h = self._spec[li]
    getattr(self, f"ladder_q{ri}").build(
        (int(np.prod(hidden[h["encoder_layer"]])),), generator)
    getattr(self, f"ladder_p{ri}").build((int(np.prod(d_shape)),), generator)

  @staticmethod
  def _mvndiag(params) -> Independent:
    return Independent(Normal(*_loc_scale(params)), 1)

  def encode(self, x):
    """(qz, (the posterior of each resolution, ...))."""
    h, hiddens = self.encoder(x, return_hidden=True)
    heads = tuple(
        self._mvndiag(getattr(self, f"ladder_q{i}")(
            _flat(hiddens[spec["encoder_layer"]])))
        for i, spec in enumerate(self.hierarchy))
    return self.latents(h), heads

  def decode(self, z, hiddens=None):
    """(px, (the prior of each resolution, ...)); the prior heads read no
    encoder state, so `hiddens` is not used (and ``reconstruct`` is the
    decode of the posterior mean, as in JAX)."""
    d, priors = z, [None] * len(self.hierarchy)
    for li, layer in enumerate(self.decoder.layers):
      d = layer(d)
      if li in self._spec:
        i, _ = self._spec[li]
        priors[i] = self._mvndiag(getattr(self, f"ladder_p{i}")(_flat(d)))
    return self.observation(d), tuple(priors)


class PUnetVAE(_PosteriorPathVAE, BetaVAE):
  """Probabilistic U-Net VAE (JAX ``hierarchical_vae.py:574-628``): beta
  10 and free bits 2 by default, one KL term ``kl_ladder{i}`` per
  resolution (free bits scaled by its units), each scaled by beta."""

  def __init__(self, beta: float = 10.0, free_bits: Optional[float] = 2.0,
               ladder_units: int = 16, **kwargs):
    self.ladder_units = int(ladder_units)
    kwargs.setdefault("name", "punetvae")
    super().__init__(beta=beta, free_bits=free_bits, **kwargs)
    if not self.hierarchy:
      raise ValueError("PUnetVAE requires a `hierarchy` spec for its ladder "
                       "map (use get_networks(..., is_hierarchical=True))")

  def _build_core(self) -> nn.Module:
    return PUnetCore(self.encoder_net, self.decoder_net, self.latents_head,
                     self.observation_head, self.hierarchy,
                     ladder_units=self.ladder_units, labels=self.labels_head)

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y = self._split_inputs(batch)
    noise = as_noise(rng)
    qz, heads_q, z = self._encode_sample(params, x, noise, training,
                                         mutables)
    px, heads_p = self._core(params, "decode", z, training=training,
                             mutables=mutables, noise=noise)
    beta = self._schedule(self.beta, step)
    llk = {"llk_image": px.log_prob(x)}
    kl = {"kl_latents": beta * self._kl_latents(qz, z)}
    for i, (qz_i, pz_i) in enumerate(zip(heads_q, heads_p)):
      kl[f"kl_ladder{i}"] = beta * _free_bits_rung(
          qz_i.kl_divergence(pz_i, analytic=True), self.free_bits,
          qz_i.event_shape)
    return llk, kl, dict(qz=qz, px=px, z=z, x=x, y=y,
                         ladder=tuple(zip(heads_q, heads_p)))


class VeryDeepVAE(HierarchicalVAE):
  """Very deep VAE (Child 2021; JAX ``hierarchical_vae.py:631-652``): the
  ladder with every KL term scaled by a linear warm-up from 1e-6 to 1 over
  `warmup_steps`, read from the step tensor (on the device, inside a
  captured graph too)."""

  def __init__(self, free_bits: Optional[float] = 0.25,
               warmup_steps: int = 2000, **kwargs):
    self._kl_schedule = linear(vmin=1e-6, vmax=1.0, steps=int(warmup_steps))
    kwargs.setdefault("name", "verydeepvae")
    super().__init__(free_bits=free_bits, **kwargs)

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    llk, kl, aux = super().elbo_components(params, batch, rng, step,
                                           training=training,
                                           mutables=mutables)
    w = self._kl_schedule(step)
    return llk, {k: w * v for k, v in kl.items()}, aux
