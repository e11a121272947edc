"""Kingma's M2 family of the port (PyTorch port of
``odin_tpu/bay/vi/autoencoder/conditional_vae.py:34-404``): ``M2VAE``
(soft labels on the unlabelled rows), ``ConditionalM2VAE`` (exact
marginalisation over the K classes: every image tiled K times, once with
each one-hot label), ``StructuredSemiVAE``, and the M3 reparameterisation
``reparamsM3VAE`` with its learned per-class prior ``PriorRegressor``.

The classifier q(y|x), the conditional encoder q(z|x, y) and decoder
p(x|z, y) are one core (``M2Core``), whose submodules carry flax's names:
``classifier``, ``x_to_qz``, ``y_to_qz``, ``xy_to_qz``, ``z_to_px``,
``y_to_px``, ``zy_to_px`` (M3: ``denotations``, ``regressor`` and no
conditional encoder).  Labelled rows add ``alpha * log q(y|x)``
(``llk_qy``, ``masked_mean_llk``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from odin_tpu_torch.bay.distributions import Independent, Normal
from odin_tpu_torch.bay.helpers import kl_divergence
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi.autoencoder.beta_vae import BetaGammaVAE
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    masked_mean_llk,
)
from odin_tpu_torch.bay.vi.utils import marginalize_categorical_labels
from odin_tpu_torch.networks.base import Dense, Flatten, SequentialNetwork
from odin_tpu_torch.networks.conditional_embedding import get_embedding
from odin_tpu_torch.training.core import as_noise

__all__ = ["M2Core", "M2VAE", "ConditionalM2VAE", "StructuredSemiVAE",
           "PriorRegressor", "M3Core", "reparamsM3VAE"]


def _entropy(p: torch.Tensor) -> torch.Tensor:
  """``-sum p log(p + 1e-6)`` over the last axis (the JAX package's H_qy;
  NaN where p is no probability vector, as a Gaussian head's mean)."""
  return -torch.sum(p * torch.log(p + 1e-6), -1)


def _uniform(z, n_classes):
  """The uniform mixture over `n_classes` for each row of z."""
  return torch.full(tuple(z.shape[:-1]) + (n_classes,), 1.0 / n_classes,
                    dtype=z.dtype, device=z.device)


def _mix(y, mask, y_soft):
  """The labelled rows' y and the others' soft labels."""
  if y is None:
    return y_soft
  if mask is None:
    return y
  m = mask.reshape(-1, 1)
  return m * y + (1 - m) * y_soft


class M2Core(nn.Module):
  """M2's classifier, conditional encoder and conditional decoder; with
  ``conditional_encoder=False`` (M3) the encoder path x -> q(z|x, y) is
  left out.  With ``classify_on_features`` the classifier reads the shared
  encoder's features, flattened, instead of x (JAX's M3
  reparameterisation flag)."""

  def __init__(self, encoder, decoder, latents, observation, labels,
               classifier, embed_dim: int = 128, n_classes: int = 10,
               embedding_method: str = "projection",
               conditional_encoder: bool = True,
               classify_on_features: bool = False):
    super().__init__()
    e = int(embed_dim)
    emb = get_embedding(embedding_method)
    self.n_classes = int(n_classes)
    self.embed_dim = e
    self.classify_on_features = bool(classify_on_features)
    self.encoder, self.decoder = encoder, decoder
    self.latents, self.observation, self.labels = latents, observation, labels
    self.classifier = classifier
    if conditional_encoder:
      self.x_to_qz = Dense(e, bare=True)
      self.y_to_qz = emb(self.n_classes, (e,))
      self.xy_to_qz = SequentialNetwork((Dense(e, "relu"), Dense(e, "relu")))
    self.z_to_px = Dense(e, bare=True)
    self.y_to_px = emb(self.n_classes, (e,))
    self.zy_to_px = SequentialNetwork((Dense(e, "relu"), Dense(e, "relu")))

  def _build_classifier(self, input_shape, generator):
    self.labels.build(self.classifier.build(tuple(input_shape), generator),
                      generator)

  def _build_decoder(self, zdim, generator):
    e = self.embed_dim
    self.z_to_px.build((zdim,), generator)
    self.y_to_px.build((self.n_classes,), generator)
    self.zy_to_px.build((2 * e,), generator)
    self.observation.build(self.decoder.build((e,), generator), generator)

  def build(self, input_shape, generator=None):
    e = self.embed_dim
    if self.classify_on_features:
      h = self.encoder.build(tuple(input_shape), generator)
      self._build_classifier((int(torch.Size(h).numel()),), generator)
    else:
      self._build_classifier(input_shape, generator)
      h = self.encoder.build(tuple(input_shape), generator)
    self.x_to_qz.build((int(torch.Size(h).numel()),), generator)
    self.y_to_qz.build((self.n_classes,), generator)
    self.xy_to_qz.build((2 * e,), generator)
    z = self.latents.build((e,), generator)
    self._build_decoder(int(torch.Size(z).numel()), generator)

  def classify(self, x):
    """q(y|x)."""
    if self.classify_on_features:
      x = self.encoder(x)
      x = x.reshape(x.shape[0], -1)
    return self.labels(self.classifier(x))

  def encode_xy(self, x, y):
    """q(z|x, y)."""
    h = self.encoder(x)
    h = self.x_to_qz(h.reshape(h.shape[0], -1))
    h = torch.cat([h, self.y_to_qz(y)], -1)
    return self.latents(self.xy_to_qz(h))

  def decode_zy(self, z, y):
    """p(x|z, y)."""
    h = torch.cat([self.z_to_px(z), self.y_to_px(y)], -1)
    return self.observation(self.decoder(self.zy_to_px(h)))

  def encode(self, x):
    """q(z|x, E[q(y|x)])."""
    return self.encode_xy(x, self.classify(x).mean())

  def decode(self, z):
    """p(x|z, y) with y the uniform mixture over the classes."""
    return self.decode_zy(z, _uniform(z, self.n_classes))

  def forward(self, *args, method: Optional[str] = None):
    if method is not None:
      return getattr(self, method)(*args)
    qy = self.classify(args[0])
    y = qy.mean()
    qz = self.encode_xy(args[0], y)
    return self.decode_zy(qz.mean(), y), qz, qy


class M2VAE(BetaGammaVAE):
  """M2 (Kingma et al. 2014) with relaxed labels on the unlabelled rows:
  their y is the classifier's q(y|x) mean."""

  def __init__(self,
               labels: Optional[RVconf] = None,
               classifier: Sequence[int] = (1024, 1024, 1024, 1024),
               activation: str = "relu",
               alpha: float = 10.0,
               embed_dim: int = 128,
               embedding_method: str = "projection",
               **kwargs):
    if labels is None:
      labels = RVconf(10, "onehot", projection=True, name="digits")
    self.alpha = float(alpha)
    self.n_classes = labels.event_size
    self.embed_dim = int(embed_dim)
    self.embedding_method = str(embedding_method)
    self._classifier_units = tuple(int(u) for u in classifier)
    self._classifier_activation = activation
    kwargs["labels"] = labels
    super().__init__(**kwargs)
    self.labels_prior = self.labels_conf.create_prior()

  @classmethod
  def is_semi_supervised(cls) -> bool:
    return True

  def _build_core(self) -> nn.Module:
    clf = SequentialNetwork((Flatten(),) + tuple(
        Dense(u, self._classifier_activation)
        for u in self._classifier_units))
    return M2Core(self.encoder_net, self.decoder_net, self.latents_head,
                  self.observation_head, self.labels_head, clf,
                  embed_dim=self.embed_dim, n_classes=self.n_classes,
                  embedding_method=self.embedding_method)

  def classify(self, x, params=None):
    """q(y|x)."""
    return self._core(params or self._params_of(), "classify",
                      self._tensor(x), mutables=self._mutables())

  def predict_labels(self, x, params=None):
    return self.classify(x, params)

  def __call__(self, x, seed: int = 0):
    """x -> (px, qz) through the posterior means (y the classifier's)."""
    px, qz, _ = self._call(self.core, "vae", self._params_of(),
                           (self._tensor(x),), mutables=self._mutables())
    return px, qz

  def decode(self, z, params=None, y=None):
    """p(x|z, y); y defaults to the uniform mixture over the classes."""
    if y is None:
      return super().decode(z, params)
    return self._core(params or self._params_of(), "decode_zy",
                      self._tensor(z), self._tensor(y),
                      mutables=self._mutables())

  def _components_xy(self, params, x, y, noise, training, mutables):
    qz = self._core(params, "encode_xy", x, y, training=training,
                    mutables=mutables, noise=noise)
    z = qz.sample_from(noise)
    px = self._core(params, "decode_zy", z, y, training=training,
                    mutables=mutables, noise=noise)
    kl_z = kl_divergence(qz, self._prior_on(z.device),
                         analytic=self.analytic, q_sample=z,
                         reverse=self.reverse, free_bits=self.free_bits)
    return px.log_prob(x), kl_z, qz, px, z

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y, mask = self._split_inputs(batch, mask=True)
    noise = as_noise(rng)
    qy = self._core(params, "classify", x, training=training,
                    mutables=mutables, noise=noise)
    y_soft = qy.mean()
    llk_x, kl_z, qz, px, z = self._components_xy(
        params, x, _mix(y, mask, y_soft), noise, training, mutables)
    if y is None:
      llk = {"llk_image_u": llk_x, "H_qy": _entropy(y_soft)}
      kl = {"kl_latents_u": kl_z}
    else:
      llk = {"llk_image": llk_x,
             "llk_qy": masked_mean_llk(self.alpha * qy.log_prob(y), mask),
             "H_qy": _entropy(y_soft)}
      kl = {"kl_latents": kl_z}
    return llk, kl, dict(qz=qz, px=px, z=z, x=x, y=y, qy=qy)


class ConditionalM2VAE(M2VAE):
  """M2 with exact marginalisation over y (Kingma et al. 2014, Eq. 7):
  ``marginal_elbo = sum_y w_y L(x, y)``, w the labelled rows' y and the
  others' q(y|x), with L(x, y) from each image tiled once per class with
  that class's one-hot label (B·K images through the encoder and the
  decoder).  The 'sequential' label embedder by default."""

  def __init__(self, embedding_method: str = "sequential", **kwargs):
    super().__init__(embedding_method=embedding_method, **kwargs)

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y, mask = self._split_inputs(batch, mask=True)
    noise = as_noise(rng)
    qy = self._core(params, "classify", x, training=training,
                    mutables=mutables, noise=noise)
    probs = qy.mean()
    x_m, y_m = marginalize_categorical_labels(x, self.n_classes)
    llk_x, kl_z, qz, px, z = self._components_xy(params, x_m, y_m, noise,
                                                 training, mutables)
    elbo_xy = llk_x.reshape(-1, self.n_classes) - \
        kl_z.reshape(-1, self.n_classes)
    w = probs if y is None else _mix(y, mask, probs)
    llk = {"marginal_elbo": torch.sum(w * elbo_xy, -1),
           "H_qy": _entropy(probs)}
    if y is not None:
      llk["llk_qy"] = masked_mean_llk(self.alpha * qy.log_prob(y), mask)
    return llk, {}, dict(qz=qz, px=px, z=z, x=x, y=y, qy=qy)


class StructuredSemiVAE(M2VAE):
  """M2 with a latent space of 64 dims by default (structure and style)."""

  def __init__(self, latents: Optional[RVconf] = None, **kwargs):
    if latents is None:
      latents = RVconf(64, "mvndiag", projection=True, name="latents")
    super().__init__(latents=latents, **kwargs)


class PriorRegressor(nn.Module):
  """The learned per-class prior p(z_c|y) of M3: four vectors set the
  diagonal normal's loc and scale between each class bit's 'true' and
  'false' values (``diag_loc_true``, ``diag_loc_false``,
  ``diag_scale_true``, ``diag_scale_false``, flax's names)."""

  def __init__(self, n_classes: int):
    super().__init__()
    self.n_classes = int(n_classes)

  def build(self, in_shape=None, generator=None):
    d = self.n_classes
    for name, fill in (("diag_loc_true", 0.0), ("diag_loc_false", 0.0),
                       ("diag_scale_true", 1.0), ("diag_scale_false", 1.0)):
      setattr(self, name, nn.Parameter(torch.full((d,), fill)))
    return (d,)

  def forward(self, y):
    loc = y * self.diag_loc_true + (1.0 - y) * self.diag_loc_false
    scale = torch.clamp(F.softplus(y * self.diag_scale_true +
                                   (1.0 - y) * self.diag_scale_false),
                        1e-3, 1e12)
    return Independent(Normal(loc, scale), 1)


class M3Core(M2Core):
  """M2's decoder with the M3 pieces: a 'denotations' latent z_c (n_classes
  dims) beside z from the shared encoder, the classifier on z_c, and the
  learned prior p(z_c|y)."""

  def __init__(self, *args, denotations=None, **kwargs):
    super().__init__(*args, conditional_encoder=False, **kwargs)
    self.denotations = denotations
    self.regressor = PriorRegressor(denotations.event_size)

  def build(self, input_shape, generator=None):
    h = self.encoder.build(tuple(input_shape), generator)
    flat = (int(torch.Size(h).numel()),)
    z = self.latents.build(flat, generator)
    zc = self.denotations.build(flat, generator)
    self._build_classifier(zc, generator)
    self.regressor.build(None, generator)
    self._build_decoder(int(torch.Size(z).numel() + torch.Size(zc).numel()),
                        generator)

  def encode_m3(self, x):
    """x -> (q(z|x), q(z_c|x)) from one encoder pass."""
    h = self.encoder(x)
    h = h.reshape(h.shape[0], -1)
    return self.latents(h), self.denotations(h)

  def classify_zc(self, z_c):
    """q(y|z_c)."""
    return self.labels(self.classifier(z_c))

  def prior_zc(self, y):
    return self.regressor(y)

  def classify(self, x):
    return self.classify_zc(self.encode_m3(x)[1].mean())

  def encode(self, x):
    """q([z, z_c]|x) as one diagonal normal (zdim + n_classes wide, what
    ``decode_zy`` takes)."""
    qz, qzc = self.encode_m3(x)
    loc = torch.cat([qz.mean(), qzc.mean()], -1)
    scale = torch.sqrt(torch.cat([qz.variance(), qzc.variance()], -1))
    return Independent(Normal(loc, scale), 1)

  def forward(self, *args, method: Optional[str] = None):
    if method is not None:
      return getattr(self, method)(*args)
    qz, qzc = self.encode_m3(args[0])
    qy = self.classify_zc(qzc.mean())
    z = torch.cat([qz.mean(), qzc.mean()], -1)
    return self.decode_zy(z, qy.mean()), qz, qy


class reparamsM3VAE(M2VAE):
  """M3 (Kingma et al. 2014): labels are inferred from the 'denotations'
  latent z_c, whose prior p(z_c|y) is learned per class; z keeps the
  fixed N(0, I) prior."""

  def _build_core(self) -> nn.Module:
    clf = SequentialNetwork(tuple(Dense(u, self._classifier_activation)
                                  for u in self._classifier_units[:2]))
    denotations = RVconf(self.n_classes, "normal", projection=True,
                         name="denotations").create_posterior()
    return M3Core(self.encoder_net, self.decoder_net, self.latents_head,
                  self.observation_head, self.labels_head, clf,
                  embed_dim=self.embed_dim, n_classes=self.n_classes,
                  embedding_method=self.embedding_method,
                  denotations=denotations)

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y, mask = self._split_inputs(batch, mask=True)
    noise = as_noise(rng)
    run = lambda method, *args: self._core(params, method, *args,
                                           training=training,
                                           mutables=mutables, noise=noise)
    qz, qzc = run("encode_m3", x)
    z = qz.sample_from(noise)
    z_c = qzc.sample_from(noise)
    qy = run("classify_zc", z_c)
    y_soft = qy.mean()
    y_mix = _mix(y, mask, y_soft)
    pzc_y = run("prior_zc", y_mix)
    px = run("decode_zy", torch.cat([z, z_c], -1), y_mix)
    kl_z = kl_divergence(qz, self._prior_on(z.device),
                         analytic=self.analytic, q_sample=z,
                         reverse=self.reverse, free_bits=self.free_bits)
    kl_zc = kl_divergence(qzc, pzc_y, analytic=self.analytic, q_sample=z_c,
                          reverse=self.reverse, free_bits=self.free_bits)
    llk = {"llk_image": px.log_prob(x), "H_qy": _entropy(y_soft)}
    if y is not None:
      llk["llk_qy"] = masked_mean_llk(self.alpha * qy.log_prob(y), mask)
    kl = {"kl_latents": kl_z, "kl_denotations": kl_zc}
    return llk, kl, dict(qz=qz, qzc=qzc, px=px, z=z, x=x, y=y, qy=qy)
