"""The auxiliary deep generative model of the port (ADGM, Maaløe et al.
2016; PyTorch port of ``odin_tpu/bay/vi/autoencoder/auxiliary_vae.py:33-188``).

Inference q(a|x) q(y|x, a) q(z|a, x, y), generation p(a|z, y) p(x|z, y);
the unlabelled rows take the classifier's soft labels and the labelled
rows add ``alpha * log q(y|x, a)`` (``llk_digits``).  The core's
submodules carry flax's names (``enc_a``, ``qa_head``, ``x_to_qy``,
``a_to_qy``, ``qy_net``, ``a_to_qz``, ``y_to_qz``, ``axy_to_qz``,
``z_to_px``, ``y_to_px``, ``zy_to_px``, ``dec_a``, ``pa_head``).

The JAX package's ``encode(x)`` and ``reconstruct`` call the core without
a and y, which its shapes refuse; here they follow the core's posterior
path (a and y at their posterior means), and ``decode(z)`` without y takes
the uniform mixture over the classes, as M2's does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from odin_tpu_torch.bay.helpers import kl_divergence
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi.autoencoder.beta_vae import BetaVAE
from odin_tpu_torch.bay.vi.autoencoder.conditional_vae import (_entropy,
                                                               _mix,
                                                               _uniform)
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    masked_mean_llk,
)
from odin_tpu_torch.networks.base import Dense, Flatten, SequentialNetwork
from odin_tpu_torch.networks.conditional_embedding import get_embedding
from odin_tpu_torch.training.core import as_noise

__all__ = ["auxiliaryVAE", "AuxiliaryVAE"]


class _ADGMCore(nn.Module):

  def __init__(self, encoder, decoder, latents, observation, labels,
               qa_head, pa_head, embed_dim: int = 128, n_classes: int = 10,
               embedding_method: str = "projection"):
    super().__init__()
    e = self.embed_dim = int(embed_dim)
    self.n_classes = int(n_classes)
    emb = get_embedding(embedding_method)
    self.encoder, self.decoder = encoder, decoder
    self.latents, self.observation, self.labels = latents, observation, labels
    self.qa_head, self.pa_head = qa_head, pa_head
    self.enc_a = SequentialNetwork((Flatten(), Dense(512, "relu"),
                                    Dense(512, "relu")))
    self.x_to_qy = Dense(e, bare=True)
    self.a_to_qy = Dense(e, bare=True)
    self.qy_net = Dense(e, "relu")
    self.a_to_qz = Dense(e, bare=True)
    self.y_to_qz = emb(self.n_classes, (e,))
    self.axy_to_qz = Dense(e, "relu")
    self.z_to_px = Dense(e, bare=True)
    self.y_to_px = emb(self.n_classes, (e,))
    self.zy_to_px = Dense(e, "relu")
    self.dec_a = Dense(512, "relu")

  def build(self, input_shape, generator=None):
    e, k = self.embed_dim, (self.n_classes,)
    a = self.qa_head.build(self.enc_a.build(tuple(input_shape), generator),
                           generator)
    self.x_to_qy.build((int(torch.Size(input_shape).numel()),), generator)
    self.a_to_qy.build(a, generator)
    self.labels.build(self.qy_net.build((2 * e,), generator), generator)
    h = self.encoder.build(tuple(input_shape), generator)
    self.a_to_qz.build(a, generator)
    self.y_to_qz.build(k, generator)
    z = self.latents.build(self.axy_to_qz.build(
        (int(torch.Size(h).numel()) + 2 * e,), generator), generator)
    self.z_to_px.build(z, generator)
    self.y_to_px.build(k, generator)
    h = self.zy_to_px.build((2 * e,), generator)
    self.observation.build(self.decoder.build(h, generator), generator)
    self.pa_head.build(self.dec_a.build(h, generator), generator)

  def encode_a(self, x):
    """q(a|x)."""
    return self.qa_head(self.enc_a(x))

  def classify(self, x, a):
    """q(y|x, a)."""
    h = torch.cat([self.x_to_qy(x.reshape(x.shape[0], -1)),
                   self.a_to_qy(a)], -1)
    return self.labels(self.qy_net(F.relu(h)))

  def encode(self, x, a, y):
    """q(z|a, x, y)."""
    h = self.encoder(x)
    h = torch.cat([h.reshape(h.shape[0], -1), self.a_to_qz(a),
                   self.y_to_qz(y)], -1)
    return self.latents(self.axy_to_qz(h))

  def decode(self, z, y):
    """(p(x|z, y), p(a|z, y))."""
    h = self.zy_to_px(torch.cat([self.z_to_px(z), self.y_to_px(y)], -1))
    return self.observation(self.decoder(h)), self.pa_head(self.dec_a(h))

  def posterior(self, x):
    """(q(a|x), q(y|x, E[a]), q(z|x, E[a], E[y])): the posterior path."""
    qa = self.encode_a(x)
    a = qa.mean()
    qy = self.classify(x, a)
    return qa, qy, self.encode(x, a, qy.mean())

  def forward(self, *args, method: str):
    return getattr(self, method)(*args)


class auxiliaryVAE(BetaVAE):
  """ADGM."""

  def __init__(self,
               labels: Optional[RVconf] = None,
               auxiliary: Optional[RVconf] = None,
               alpha: float = 1.0,
               embed_dim: int = 128,
               embedding_method: str = "projection",
               **kwargs):
    if labels is None:
      labels = RVconf(10, "onehot", projection=True, name="digits")
    if auxiliary is None:
      auxiliary = RVconf(64, "mvndiag", projection=True, name="auxiliary")
    self.alpha = float(alpha)
    self.embed_dim = int(embed_dim)
    self.embedding_method = str(embedding_method)
    self.auxiliary_conf = auxiliary
    kwargs["labels"] = labels
    super().__init__(**kwargs)
    self.a_prior = auxiliary.create_prior()

  @classmethod
  def is_semi_supervised(cls) -> bool:
    return True

  @property
  def n_classes(self) -> int:
    return self.labels_conf.event_size

  def _build_core(self) -> nn.Module:
    return _ADGMCore(self.encoder_net, self.decoder_net, self.latents_head,
                     self.observation_head, self.labels_head,
                     self.auxiliary_conf.create_posterior(name="qa_x"),
                     self.auxiliary_conf.create_posterior(name="pa_zy"),
                     embed_dim=self.embed_dim, n_classes=self.n_classes,
                     embedding_method=self.embedding_method)

  def _posterior(self, x, params):
    return self._core(params or self._params_of(), "posterior",
                      self._tensor(x), mutables=self._mutables())

  def classify(self, x, params=None):
    """q(y|x, E[q(a|x)])."""
    return self._posterior(x, params)[1]

  def predict_labels(self, x, params=None):
    return self.classify(x, params)

  def encode(self, x, params=None):
    """q(z|x, E[a], E[y])."""
    return self._posterior(x, params)[2]

  def decode(self, z, params=None, y=None):
    """p(x|z, y), y the uniform mixture over the classes by default."""
    z = self._tensor(z)
    y = _uniform(z, self.n_classes) if y is None else self._tensor(y)
    return self._core(params or self._params_of(), "decode", z, y,
                      mutables=self._mutables())[0]

  def reconstruct(self, x, params=None):
    """(qz, px) through the posterior means of a, y and z."""
    params = params or self._params_of()
    _, qy, qz = self._posterior(x, params)
    return qz, self._core(params, "decode", qz.mean(), qy.mean(),
                          mutables=self._mutables())[0]

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y, mask = self._split_inputs(batch, mask=True)
    noise = as_noise(rng)
    run = lambda method, *args: self._core(params, method, *args,
                                           training=training,
                                           mutables=mutables, noise=noise)
    qa = run("encode_a", x)
    a = qa.sample_from(noise)
    qy = run("classify", x, a)
    y_soft = qy.mean()
    y_use = _mix(y, mask, y_soft)
    qz = run("encode", x, a, y_use)
    z = qz.sample_from(noise)
    px, pa = run("decode", z, y_use)
    llk = {"llk_image": px.log_prob(x),
           "llk_auxiliary": pa.log_prob(a),
           "H_qy": _entropy(y_soft)}
    beta = self._schedule(self.beta, step)
    kl = {"kl_latents": beta * kl_divergence(
              qz, self._prior_on(z.device), analytic=self.analytic,
              q_sample=z, reverse=self.reverse, free_bits=self.free_bits),
          "kl_auxiliary": qa.log_prob(a)}
    if y is not None:
      llk["llk_digits"] = masked_mean_llk(self.alpha * qy.log_prob(y), mask)
    return llk, kl, dict(qz=qz, px=px, z=z, x=x, y=y, qy=qy, qa=qa)


AuxiliaryVAE = auxiliaryVAE
