"""Amortized LDA of the port: Dirichlet-latent topic models as VAEs
(PyTorch port of ``odin_tpu/bay/vi/autoencoder/lda_vae.py``:
``LatentDirichletDecoder`` :31-49, ``_LDACore`` :52-67, ``amortizedLDA``
:70-183, ``nonlinearLDA`` :186, ``auxiliaryLDA`` :194, ``ALDA`` :227).

The encoder reads ``log1p`` of the word counts and gives a Dirichlet
posterior over the topic mixture theta; the decoder is the topic-word
matrix (``log(theta @ softmax(topics_words) + 1e-10)``) or, nonlinear, a
Dense(64) and a log-softmax; the likelihood is ``sum(x * log_word)``, the
multinomial's without its constant, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from odin_tpu_torch.bay.distributions import Dirichlet
from odin_tpu_torch.bay.helpers import kl_divergence
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    VariationalAutoencoder,
    masked_mean_llk,
)
from odin_tpu_torch.networks.base import Dense, SequentialNetwork
from odin_tpu_torch.training.core import TrainStep, as_noise

__all__ = ["LatentDirichletDecoder", "amortizedLDA", "auxiliaryLDA",
           "nonlinearLDA", "ALDA"]


class LatentDirichletDecoder(nn.Module):
  """theta -> log word probabilities through the topic-word matrix
  ``topics_words`` (n_topics, n_words), or through ``nonlinear``
  (Dense(64, relu)) and the Dense ``topics_words`` with `nonlinear`."""

  def __init__(self, n_words: int, n_topics: int = 10,
               nonlinear: bool = False):
    super().__init__()
    self.n_words = int(n_words)
    self.n_topics = int(n_topics)
    self.is_nonlinear = bool(nonlinear)

  def build(self, in_shape, generator=None):
    if self.is_nonlinear:
      self.nonlinear = Dense(64, "relu")
      self.topics_words = Dense(self.n_words, bare=True)
      self.topics_words.build(self.nonlinear.build(tuple(in_shape),
                                                   generator), generator)
    else:  # flax's normal(1.0) init
      self.topics_words = nn.Parameter(torch.randn(
          self.n_topics, self.n_words, generator=generator))
    return (self.n_words,)

  def forward(self, theta):
    if self.is_nonlinear:
      return F.log_softmax(self.topics_words(self.nonlinear(theta)), dim=-1)
    word_probs = theta @ torch.softmax(self.topics_words, dim=-1)
    return torch.log(word_probs + 1e-10)


class _LDACore(nn.Module):

  def __init__(self, encoder: nn.Module, latents: nn.Module,
               topic_decoder: LatentDirichletDecoder):
    super().__init__()
    self.encoder = encoder
    self.latents = latents
    self.topic_decoder = topic_decoder

  def build(self, input_shape, generator=None):
    h = self.encoder.build(tuple(input_shape), generator)
    self.topic_decoder.build(self.latents.build(h, generator), generator)

  def encode(self, x) -> Dirichlet:
    return self.latents(self.encoder(torch.log1p(x)))

  def decode(self, theta) -> torch.Tensor:
    return self.topic_decoder(theta)

  def forward(self, *args, method: Optional[str] = None):
    if method is not None:
      return getattr(self, method)(*args)
    q_theta = self.encode(args[0])
    return self.decode(q_theta.mean()), q_theta


class amortizedLDA(VariationalAutoencoder):
  """Amortized LDA: ``lda = amortizedLDA(n_words=200, n_topics=8).build()``
  on (B, n_words) count vectors; ``perplexity``, ``transform`` and
  ``get_topics`` as the JAX package's.  The prior is
  ``Dirichlet(prior_concentration)`` on every topic."""

  def __init__(self, n_words: int, n_topics: int = 10,
               prior_concentration: float = 0.7, encoder=None,
               nonlinear: bool = False, **kwargs):
    self.n_words = int(n_words)
    self.n_topics = int(n_topics)
    self.nonlinear = bool(nonlinear)
    if encoder is None:
      encoder = SequentialNetwork((Dense(128, "relu"), Dense(128, "relu")))
    for k in ("latents", "observation", "decoder"):
      kwargs.pop(k, None)
    kwargs.setdefault("input_shape", (self.n_words,))
    super().__init__(encoder=encoder, decoder=None,
                     latents=RVconf(self.n_topics, "dirichlet",
                                    projection=True, name="topics"),
                     observation=RVconf((self.n_words,), "deterministic",
                                        projection=False, name="docs"),
                     **kwargs)
    self.prior_concentration = float(prior_concentration)

  @property
  def latents_prior(self) -> Dirichlet:
    return Dirichlet(torch.full((self.n_topics,), self.prior_concentration))

  def _build_core(self) -> nn.Module:
    return _LDACore(self.encoder_net, self.latents_head,
                    LatentDirichletDecoder(self.n_words, self.n_topics,
                                           self.nonlinear))

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y = self._split_inputs(batch)
    noise = as_noise(rng)
    q_theta = self._apply(params, "encode", x, training, mutables, noise)
    theta = q_theta.sample_from(noise)
    log_word = self._apply(params, "decode", theta, training, mutables, noise)
    llk = {"llk_docs": torch.sum(x * log_word, dim=-1)}
    kl = {"kl_topics": kl_divergence(q_theta, self._prior_on(theta.device),
                                     analytic=self.analytic, q_sample=theta,
                                     reverse=self.reverse)}
    return llk, kl, dict(qz=q_theta, px=None, z=theta, x=x, y=y,
                         log_word=log_word)

  def _vae_loss(self, params, batch, rng, step, mutables):
    llk, kl, aux = self.elbo_components(params, batch, rng, step,
                                        training=True, mutables=mutables)
    elbo = self.elbo(llk, kl)
    loss = -torch.mean(elbo)
    metrics = {k: torch.mean(v) for k, v in {**llk, **kl}.items()}
    n_words = torch.sum(aux["x"], dim=-1)
    metrics["perplexity"] = torch.exp(-torch.mean(elbo) / torch.clamp(
        torch.mean(n_words), min=1.0))
    return loss, (metrics, mutables)

  @torch.no_grad()
  def perplexity(self, x, seed: int = 0) -> float:
    """Corpus perplexity ``exp(-sum(elbo) / n_words)``, the noise from a
    generator seeded `seed`."""
    x = self._tensor(x)
    llk, kl, _ = self.elbo_components(self._params_of(), x,
                                      self._generator(seed), self.state.step,
                                      mutables=self._mutables())
    elbo = self.elbo(llk, kl)
    return float(torch.exp(-torch.sum(elbo) / torch.clamp(torch.sum(x),
                                                          min=1.0)))

  @torch.no_grad()
  def transform(self, x, seed: int = 0) -> np.ndarray:
    """Posterior document-topic mixtures (n_docs, n_topics), rows summing
    to 1 (scikit-learn's ``LatentDirichletAllocation.transform``)."""
    theta = self.encode(x).mean()
    theta = theta / torch.clamp(torch.sum(theta, -1, keepdim=True),
                                min=1e-12)
    return theta.cpu().numpy()

  @torch.no_grad()
  def get_topics(self, top_k: int = 10):
    """(indices of each topic's `top_k` words, the topic-word
    probabilities (n_topics, n_words)): the linear decoder's
    ``topics_words`` read directly, the nonlinear decoder probed with the
    one-hot topic mixtures."""
    params = self._params_of()
    p = params["vae"].get("topic_decoder.topics_words")
    if p is not None:
      probs = torch.softmax(p, dim=-1)
    else:
      eye = torch.eye(self.n_topics, dtype=torch.float32, device=self.device)
      probs = torch.exp(self._apply(params, "decode", eye,
                                    mutables=self._mutables()))
      probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-12)
    idx = torch.argsort(-probs, dim=-1)[:, :top_k]
    return idx.cpu().numpy(), probs.cpu().numpy()


class nonlinearLDA(amortizedLDA):
  """Amortized LDA with the nonlinear topic decoder."""

  def __init__(self, n_words: int, **kwargs):
    kwargs.pop("nonlinear", None)
    super().__init__(n_words=n_words, nonlinear=True, **kwargs)


class auxiliaryLDA(amortizedLDA):
  """Amortized LDA with a supervised head on theta: batches ``(x, y,
  mask)`` (y integer labels or one-hot, mask 1 on the labelled rows) add
  ``alpha * log q(y | theta)``, averaged over the labelled rows, as
  ``llk_labels``; y absent, the plain LDA."""

  def __init__(self, n_words: int, n_labels: int = 10, alpha: float = 10.0,
               **kwargs):
    self.n_labels = int(n_labels)
    self.alpha = float(alpha)
    super().__init__(n_words=n_words, **kwargs)
    self._labels_head2 = RVconf(self.n_labels, "onehot", projection=True,
                                name="topics_labels").create_posterior()

  def extra_networks(self):
    return {"labels": (self._labels_head2, (self.n_topics,))}

  @classmethod
  def is_semi_supervised(cls) -> bool:
    return True

  def train_steps(self):
    return [TrainStep(loss_fn=self._vae_loss, partitions=("vae", "labels"),
                      name="vae")]

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y, mask = self._split_inputs(batch, mask=True)
    noise = as_noise(rng)
    llk, kl, aux = super().elbo_components(params, x, noise, step,
                                           training=training,
                                           mutables=mutables)
    if y is not None:
      if y.ndim == 1:  # integer labels -> one-hot
        y = F.one_hot(y.long(), self.n_labels).to(torch.float32)
      qy = self._apply_module(params, "labels", aux["z"], training=training,
                              mutables=mutables, noise=noise)
      llk["llk_labels"] = masked_mean_llk(self.alpha * qy.log_prob(y), mask)
    return llk, kl, aux


class ALDA(amortizedLDA):
  """The JAX package's alias of ``amortizedLDA``."""
