"""FactorVAE and Factor2VAE of the port (PyTorch port of
``odin_tpu/bay/vi/autoencoder/factor_vae.py:44-273``).

Each training iteration splits the batch in half: the ELBO step (the VAE
partition, adding ``tc_coef * mean(D(z))`` to the KL terms) on the first
half, the discriminator step (the 'discriminator' partition, real codes
against ``permute_dims`` codes) on the second, each with its own optimizer
and its own NaN-skip inside one step function (one CUDA graph on the
card).  The discriminator's Adam runs at lr 1e-4 with b1 0.5, b2 0.9.
``SemiFactorVAE`` and ``SemiFactor2VAE`` (``factor_vae.py:170-199,
275-291``) give the discriminator `n_labels` more outputs, and the
discriminator's half of an (x, y, mask) batch adds its supervised term.
As in the JAX package that half is the second one, so that with the
labelled rows first in every batch the ELBO's half is the labelled one.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from odin_tpu_torch.bay.distributions import MultivariateNormalDiag
from odin_tpu_torch.bay.helpers import kl_divergence
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi.autoencoder.beta_vae import AnnealingVAE
from odin_tpu_torch.bay.vi.autoencoder.factor_discriminator import (
    FactorDiscriminator,
    dtc_loss_logits,
    total_correlation_logits,
)
from odin_tpu_torch.bay.vi.utils import permute_dims
from odin_tpu_torch.training.core import (TrainStep, _tree_leaves, _tree_map,
                                          as_noise)

__all__ = ["FactorVAE", "Factor2VAE", "SemiFactorVAE", "SemiFactor2VAE"]


def _split_half(batch):
  """(first half, second half) of every tensor of a batch along axis 0; an
  odd batch raises (the JAX package drops its last row)."""
  sizes = sorted({int(t.shape[0]) for t in _tree_leaves(batch)})
  if any(n % 2 for n in sizes):
    raise ValueError(f"FactorVAE trains on a batch split in half; the "
                     f"batch has an odd size {sizes}")
  first = _tree_map(lambda t: t[:t.shape[0] // 2], batch)
  second = _tree_map(lambda t: t[t.shape[0] // 2:], batch)
  return first, second


class FactorVAE(AnnealingVAE):
  """Disentangling by Factorising (Kim & Mnih 2018).  Give it twice the
  batch size: each iteration splits the batch into the VAE's half and the
  discriminator's half.  Recommended `tc_coef`: dSprites 35, Shapes3D 7,
  CelebA 6.4."""

  def __init__(self,
               discriminator_units: Sequence[int] = (1000,) * 5,
               activation: str = "relu",
               batchnorm: bool = False,
               tc_coef: float = 7.0,
               maximize_tc: bool = False,
               discriminator_lr: float = 1e-4,
               n_discriminator_outputs: int = 1,
               ss_strategy: str = "logsumexp",
               **kwargs):
    self.discriminator = FactorDiscriminator(
        units=tuple(int(u) for u in discriminator_units),
        activation=activation, batchnorm=batchnorm,
        n_outputs=int(n_discriminator_outputs), ss_strategy=ss_strategy)
    self.tc_coef = float(tc_coef)
    self.maximize_tc = bool(maximize_tc)
    self.discriminator_lr = float(discriminator_lr)
    self._is_pretraining = False
    self._tc_name = "tc"
    super().__init__(**kwargs)

  # -- pretraining switch ------------------------------------------------------
  @property
  def is_pretraining(self) -> bool:
    return self._is_pretraining

  def pretrain(self) -> "FactorVAE":
    """Train the VAE alone: no TC term, no discriminator step."""
    self._is_pretraining = True
    return self

  def finetune(self) -> "FactorVAE":
    self._is_pretraining = False
    return self

  # -- wiring ------------------------------------------------------------------
  def _tc_slice(self, z):
    """The codes the discriminator judges (Factor2VAE: the factors)."""
    return z

  @property
  def _disc_input_dim(self) -> int:
    return self.zdim

  def extra_networks(self):
    return {"discriminator": (self.discriminator, (self._disc_input_dim,))}

  def optimizer_specs(self):
    return {"discriminator": dict(optimizer="adam",
                                  learning_rate=self.discriminator_lr,
                                  kwargs=dict(b1=0.5, b2=0.9))}

  def _discriminator_logits(self, params, z, training, mutables, noise):
    logits = self._apply_module(params, "discriminator", z,
                                training=training, mutables=mutables,
                                noise=noise)
    return self.discriminator.tc_logits(logits)

  # -- objectives --------------------------------------------------------------
  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    noise = as_noise(rng)
    llk, kl, aux = super().elbo_components(params, batch, noise, step,
                                           training=training,
                                           mutables=mutables)
    if not (self.is_pretraining and training):
      z = self._tc_slice(aux["z"].reshape(-1, self.zdim))
      tc_logit = self._discriminator_logits(params, z, training, mutables,
                                            noise)
      tc = self.tc_coef * total_correlation_logits(tc_logit)
      if self.maximize_tc:
        tc = -tc
      kl[self._tc_name] = tc * torch.ones(z.shape[0], dtype=z.dtype,
                                          device=z.device)
    return llk, kl, aux

  def dtc_loss(self, params, batch, rng, step, mutables):
    """The discriminator's loss on a half batch: its codes (no gradient to
    the VAE) against their ``permute_dims``."""
    x, y = self._split_inputs(batch)
    noise = as_noise(rng)
    # the VAE runs in training mode, as in the JAX package, but this step
    # does not move the VAE's buffers
    qz = self._apply(params, "encode", x, True, dict(mutables or {}), noise)
    z = self._tc_slice(qz.sample_from(noise).reshape(-1, self.zdim)).detach()
    z_logit = self._discriminator_logits(params, z, True, mutables, noise)
    z_perm = permute_dims(z, uniforms=noise.uniform(
        tuple(z.shape[-2:]), z.dtype, z.device))
    zperm_logit = self._discriminator_logits(params, z_perm, True, mutables,
                                             noise)
    loss = dtc_loss_logits(z_logit, zperm_logit)
    metrics = {"dtc_loss": loss}
    sup = self._supervised_loss(params, z, y, mutables, noise)
    if sup is not None:
      loss = loss + sup
      metrics["supv_loss"] = sup
    return loss, (metrics, mutables)

  def _supervised_loss(self, params, z, y, mutables, noise):
    """The discriminator's supervised term (SemiFactorVAE), or None."""
    return None

  # -- training ----------------------------------------------------------------
  def _vae_half_loss(self, params, batch, rng, step, mutables):
    first, _ = _split_half(batch)
    return self._vae_loss(params, first, rng, step, mutables)

  def _disc_half_loss(self, params, batch, rng, step, mutables):
    _, second = _split_half(batch)
    return self.dtc_loss(params, second, rng, step, mutables)

  def train_steps(self) -> List[TrainStep]:
    steps = [TrainStep(loss_fn=self._vae_half_loss, partitions=("vae",),
                       name="elbo")]
    if not self.is_pretraining:
      steps.append(TrainStep(loss_fn=self._disc_half_loss,
                             partitions=("discriminator",), name="disc"))
    return steps


class Factor2VAE(FactorVAE):
  """FactorVAE with two latent spaces: content `latents` and `factors`,
  one fused mvndiag head over both (as the JAX package fuses them); the
  discriminator, ``permute_dims`` and the TC term see only the factors,
  and the KL is reported for each space."""

  def __init__(self,
               latents: Optional[RVconf] = None,
               factors: Optional[RVconf] = None,
               **kwargs):
    if latents is None:
      latents = RVconf(5, "mvndiag", projection=True, name="latents")
    if factors is None:
      factors = RVconf(5, "mvndiag", projection=True, name="factors")
    if not isinstance(factors, RVconf):
      raise ValueError(f"factors must be RVconf, given: {type(factors)}")
    if not latents.posterior == factors.posterior == "mvndiag":
      raise ValueError("Factor2VAE fuses the two heads into one mvndiag "
                       "head; both latents and factors must use the "
                       "'mvndiag' posterior")
    self.content_dim = int(np.prod(latents.event_shape))
    self.factors_dim = int(np.prod(factors.event_shape))
    self.content_name = latents.name or "latents"
    self.factors_name = factors.name or "factors"
    combined = latents.copy(
        event_shape=(self.content_dim + self.factors_dim,), name="latents")
    super().__init__(latents=combined, **kwargs)
    self._tc_name = f"tc_{self.factors_name}"

  @property
  def _disc_input_dim(self) -> int:
    return self.factors_dim

  def _tc_slice(self, z):
    return z[..., self.content_dim:]

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    llk, kl, aux = super().elbo_components(params, batch, rng, step,
                                           training=training,
                                           mutables=mutables)
    qz, z = aux["qz"], aux["z"]
    prior = self._prior_on(z.device)
    if isinstance(qz, MultivariateNormalDiag) and \
        isinstance(prior, MultivariateNormalDiag):
      d1 = self.content_dim
      del kl[next(k for k in kl if k.startswith("kl_"))]
      for name, sl in ((self.content_name, slice(None, d1)),
                       (self.factors_name, slice(d1, None))):
        q = MultivariateNormalDiag(qz.loc[..., sl], qz.scale_diag[..., sl])
        p = MultivariateNormalDiag(prior.loc[..., sl],
                                   prior.scale_diag[..., sl])
        kl[f"kl_{name}"] = kl_divergence(
            q, p, analytic=self.analytic,
            q_sample=None if self.analytic else z[..., sl],
            reverse=self.reverse, free_bits=self.free_bits)
    return llk, kl, aux


class SemiFactorVAE(FactorVAE):
  """Semi-supervised FactorVAE: the discriminator gains `n_labels` label
  logits (``1 + n_labels`` outputs, reduced by `ss_strategy` for the TC
  estimate), and its step adds ``-alpha * mean(sum(y * log_softmax))``
  of its half's labels."""

  def __init__(self,
               n_labels: int = 10,
               alpha: float = 10.0,
               ss_strategy: str = "logsumexp",
               **kwargs):
    self.n_labels = int(n_labels)
    self.alpha = float(alpha)
    kwargs.setdefault("n_discriminator_outputs", 1 + self.n_labels)
    super().__init__(ss_strategy=ss_strategy, **kwargs)

  @classmethod
  def is_semi_supervised(cls) -> bool:
    return True

  def label_logits(self, z, params=None, training=False, mutables=None,
                   noise=None):
    """The discriminator's label logits of the codes z."""
    logits = self._apply_module(params or self._params_of(), "discriminator",
                                z, training=training, mutables=mutables,
                                noise=noise)
    return logits[..., 1:1 + self.n_labels]

  def predict_labels(self, x, params=None):
    """The labels' one-hot categorical from the discriminator's label
    logits at the posterior mean of x (its log_prob(y) is the supervised
    term's ``sum(y * log_softmax)``)."""
    from odin_tpu_torch.bay.distributions import OneHotCategorical
    params = params or self._params_of()
    z = self._tc_slice(self.encode(x, params).mean())
    return OneHotCategorical(logits=self.label_logits(
        z, params, mutables=self._mutables()))

  def _supervised_loss(self, params, z, y, mutables, noise):
    if y is None:
      return None
    log_p = F.log_softmax(self.label_logits(z, params, True, mutables, noise),
                          dim=-1)
    y = y.reshape(y.shape[0], -1)[:, :self.n_labels]
    return -self.alpha * torch.mean(torch.sum(y * log_p, dim=-1))


class SemiFactor2VAE(SemiFactorVAE, Factor2VAE):
  """Semi-supervised Factor2VAE: the discriminator's label logits, like
  its TC logit, see only the ``factors`` latent."""

  def __init__(self,
               latents: Optional[RVconf] = None,
               factors: Optional[RVconf] = None,
               n_labels: int = 10,
               alpha: float = 10.0,
               **kwargs):
    if latents is None:
      latents = RVconf(5, "mvndiag", projection=True, name="latents")
    if factors is None:
      factors = RVconf(5, "mvndiag", projection=True, name="factors")
    super().__init__(latents=latents, factors=factors, n_labels=n_labels,
                     alpha=alpha, **kwargs)
