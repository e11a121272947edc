"""The SemafoVAE family of the port (PyTorch port of
``odin_tpu/bay/vi/autoencoder/semafo_vae.py:35-498``): semi-supervised
VAEs whose labels head p(y|z) reads the latents, with a mutual-information
term on prior samples: decode z' ~ p(z), encode the image again, and
penalise ``D_kl(q(y|z~) || p(y|z))`` (``RemafoVAE``: the reverse).

The term's coefficient ``mi_coef`` is a schedule of the step (0.1 to 0.05
over 20,000 steps by default) counted from ``steps_without_mi``, and no
gradient flows through the term before that step (its value still logs).
Both read the step as a tensor, so that k steps captured in one CUDA graph
cross the gate as eager steps do.

Variants: ``semafod`` (a second, label-aligned latent z_y; ``semafoh``
conditions it on [h, z]), ``semafos`` (the decoder takes [z, y] and the
supervised term trains in a second ``TrainStep`` on the same partition and
optimizer), ``semafosm`` (the decoder takes z alone), ``semafosc`` (the
decoder always takes the predicted labels), ``semafop`` (the divergence
between the unlabelled and the labelled rows), ``semafot`` (a longer
warm-up).
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from odin_tpu_torch.backend.interpolation import Interpolation, linear
from odin_tpu_torch.bay.helpers import kl_divergence, map_distributions
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi.autoencoder.beta_vae import AnnealingVAE
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    masked_mean_llk,
)
from odin_tpu_torch.networks.base import layer_noise
from odin_tpu_torch.training.core import Noise, TrainStep, as_noise

__all__ = ["SemafoVAE", "RemafoVAE", "semafod", "semafoh", "semafos",
           "semafosm", "semafosc", "semafop", "semafot"]


def _ones(z):
  return torch.ones(z.shape[0], dtype=z.dtype, device=z.device)


class SemafoVAE(AnnealingVAE):
  """Semaphore VAE: `mi_coef` weighs the agreement of q(y|z) and p(y|z) on
  prior samples (0.1 to 0.5 for MNIST; 0.1 for dSprites, Shapes3D and
  CelebA)."""

  def __init__(self,
               labels: Optional[RVconf] = None,
               alpha: float = 10.0,
               mi_coef: Union[float, Interpolation] = None,
               reverse_mi: bool = False,
               steps_without_mi: int = 1000,
               **kwargs):
    if labels is None:
      labels = RVconf(10, "onehot", projection=True, name="digits")
    if mi_coef is None:
      mi_coef = linear(vmin=0.1, vmax=0.05, steps=20000)
    self._mi_coef = mi_coef
    self.alpha = float(alpha)
    self.reverse_mi = bool(reverse_mi)
    self.steps_without_mi = int(steps_without_mi)
    self.skip_decoder = True  # the labels head reads the latents
    kwargs["labels"] = labels
    super().__init__(**kwargs)

  @classmethod
  def is_semi_supervised(cls) -> bool:
    return True

  @property
  def _labels_name(self) -> str:
    return self.labels_conf.name if self.labels_conf is not None \
        else "labels"

  def mi_coef(self, step) -> torch.Tensor:
    """The coefficient at `step`: a schedule counts from
    ``steps_without_mi``."""
    if isinstance(self._mi_coef, Interpolation):
      step = torch.as_tensor(step)
      return self._mi_coef(torch.clamp(
          step.to(torch.float32) - self.steps_without_mi, min=0.0))
    return torch.tensor(self._mi_coef, dtype=torch.float32)

  def _gate(self, mi_y, step, training):
    """No gradient through `mi_y` before ``steps_without_mi`` (nor out of
    training); a tensor comparison, never a Python branch on the step."""
    if not training:
      return mi_y.detach()
    step = torch.as_tensor(step, device=mi_y.device)
    return torch.where(step >= self.steps_without_mi, mi_y, mi_y.detach())

  def predict_factors(self, params, z, training=False, mutables=None,
                      noise=None):
    """p(y|z)."""
    return self._core(params, "predict_labels", z, training=training,
                      mutables=mutables, noise=noise)

  def predict_labels(self, x=None, latents=None, params=None):
    """p(y|.) at the posterior mean of x, or at `latents`."""
    params = params or self._params_of()
    z = self.encode(x, params).mean() if latents is None \
        else self._tensor(latents)
    return self.predict_factors(params, z, mutables=self._mutables())

  def _mi_loss(self, params, qz, py_z, noise, step, training, mutables):
    run = lambda method, *args: self._core(params, method, *args,
                                           training=training,
                                           mutables=mutables, noise=noise)
    z_prime = self._prior_on(py_z.mean().device).sample_from(
        noise, (qz.batch_shape[0],))
    qz_prime = run("encode", run("decode", z_prime).mean())
    qy_z = self.predict_factors(params, qz_prime.sample_from(noise),
                                training, mutables, noise)
    if self.reverse_mi:  # D_kl(p(y|z) || q(y|z))
      y_s = py_z.sample_from(noise).detach()
      dkl = py_z.log_prob(y_s) - qy_z.log_prob(y_s)
    else:  # D_kl(q(y|z) || p(y|z))
      y_s = qy_z.sample_from(noise).detach()
      dkl = qy_z.log_prob(y_s) - py_z.log_prob(y_s)
    mi_y = self.mi_coef(step) * self._gate(torch.mean(dkl), step, training)
    mi_z = torch.clamp(torch.mean(qz_prime.log_prob(z_prime)).detach(),
                       -1e8, 1e8)
    return mi_y, mi_z

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y, mask = self._split_inputs(batch, mask=True)
    noise = as_noise(rng)
    llk, kl, aux = super().elbo_components(params, x, noise, step,
                                           training=training,
                                           mutables=mutables)
    z = aux["z"]
    py_z = self.predict_factors(params, z, training, mutables, noise)
    aux["qy"] = py_z
    mi_y, mi_z = self._mi_loss(params, aux["qz"], py_z, noise, step,
                               training, mutables)
    name = self._labels_name
    llk[f"mi_{name}"] = mi_y * _ones(z)
    llk["mi_latents"] = mi_z * torch.zeros_like(_ones(z))  # logged only
    if y is not None:
      llk[f"llk_{name}"] = masked_mean_llk(self.alpha * py_z.log_prob(y),
                                           mask)
    return llk, kl, aux


class RemafoVAE(SemafoVAE):
  """SemafoVAE minimising the reverse divergence D_kl(p(y|z) || q(y|z))."""

  def __init__(self, **kwargs):
    kwargs.pop("reverse_mi", None)
    super().__init__(reverse_mi=True, **kwargs)


class _DualLatentCore(nn.Module):
  """Two latent heads, q(z|h) and a label-aligned q(z_y|.), decoded
  together from [z, z_y]; ``hierarchical`` (semafoh) conditions z_y on
  [h, z] with z drawn from q(z|h) (from the ``Noise`` the model hands its
  core)."""

  def __init__(self, encoder, decoder, latents, latents_y, observation,
               labels, hierarchical: bool = False):
    super().__init__()
    self.encoder, self.decoder = encoder, decoder
    self.latents, self.latents_y = latents, latents_y
    self.observation, self.labels = observation, labels
    self.hierarchical = bool(hierarchical)

  def build(self, input_shape, generator=None):
    h = self.encoder.build(tuple(input_shape), generator)
    z = self.latents.build(h, generator)
    zy = self.latents_y.build(
        (h[-1] + z[-1],) if self.hierarchical else h, generator)
    self.labels.build(zy, generator)
    self.observation.build(self.decoder.build((z[-1] + zy[-1],), generator),
                           generator)

  def encode(self, x):
    h = self.encoder(x)
    qz1 = self.latents(h)
    if self.hierarchical:
      z1 = qz1.sample_from(layer_noise())
      return qz1, self.latents_y(torch.cat([h, z1], -1))
    return qz1, self.latents_y(h)

  def decode(self, z):
    """z is [z, z_y]."""
    return self.observation(self.decoder(z))

  def predict_labels(self, z2):
    return self.labels(z2)

  def forward(self, *args, method: str):
    return getattr(self, method)(*args)


class semafod(SemafoVAE):
  """Semafo with double latents: a second latent z_y (n_labels dims) beside
  z; p(y|z_y); decode from [z, z_y]; a beta-weighted KL on z_y too."""

  hierarchical_zy = False

  def __init__(self, **kwargs):
    super().__init__(**kwargs)
    self._latents_y_prior = self._latents_y_conf.create_prior()

  def _build_core(self):
    n_labels = self.labels_conf.event_size if self.labels_conf is not None \
        else 10
    self._latents_y_conf = RVconf(int(n_labels), "mvndiag", projection=True,
                                  name="latents_y")
    return _DualLatentCore(self.encoder_net, self.decoder_net,
                           self.latents_head,
                           self._latents_y_conf.create_posterior(),
                           self.observation_head, self.labels_head,
                           hierarchical=self.hierarchical_zy)

  def _prior_y_on(self, device):
    """p(z_y) with its parameters on `device`, built once per device."""
    key = ("latents_y", device)
    if key not in self._priors:
      self._priors[key] = map_distributions(lambda t: t.to(device),
                                            self._latents_y_prior)
    return self._priors[key]

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y, mask = self._split_inputs(batch, mask=True)
    noise = as_noise(rng)
    run = lambda method, *args: self._core(params, method, *args,
                                           training=training,
                                           mutables=mutables, noise=noise)
    qz1, qz2 = run("encode", x)
    z1 = qz1.sample_from(noise)
    z2 = qz2.sample_from(noise)
    px = run("decode", torch.cat([z1, z2], -1))
    beta = self._schedule(self.beta, step)
    prior, prior_y = self._prior_on(z1.device), self._prior_y_on(z1.device)
    obs_name = self.core.observation.name or "observation"
    llk = {f"llk_{obs_name}": px.log_prob(x)}
    kl = {"kl_latents": beta * kl_divergence(
              qz1, prior, analytic=self.analytic, q_sample=z1,
              reverse=self.reverse, free_bits=self.free_bits),
          "kl_latents_y": beta * kl_divergence(
              qz2, prior_y, analytic=self.analytic, q_sample=z2,
              reverse=self.reverse, free_bits=self.free_bits)}
    py_z = run("predict_labels", z2)
    name = self._labels_name
    if y is not None:
      llk[f"llk_{name}"] = masked_mean_llk(self.alpha * py_z.log_prob(y),
                                           mask)
    # MI on prior samples z' ~ p(z) p(z_y): decode, encode again, and the
    # agreement of q(y|z_y~) with p(y|z_y)
    b = z1.shape[0]
    z1p = prior.sample_from(noise, (b,))
    z2p = prior_y.sample_from(noise, (b,))
    xp = run("decode", torch.cat([z1p, z2p], -1)).mean()
    _, qz2p = run("encode", xp)
    qy_z = run("predict_labels", qz2p.sample_from(noise))
    y_s = qy_z.sample_from(noise).detach()
    mi_y = self._gate(torch.mean(qy_z.log_prob(y_s) - py_z.log_prob(y_s)),
                      step, training)
    llk[f"mi_{name}"] = self.mi_coef(step) * mi_y * _ones(z1)
    return llk, kl, dict(qz=qz1, qz_y=qz2, px=px, z=z1, x=x, y=y)

  def _encode_pair(self, x, params, seed):
    return self._core(params or self._params_of(), "encode", self._tensor(x),
                      mutables=self._mutables(),
                      noise=Noise(self._generator(seed)))

  def encode(self, x, params=None, seed: int = 0):
    """q(z|x) (semafoh draws its z for q(z_y|.) from a generator seeded
    `seed`)."""
    return self._encode_pair(x, params, seed)[0]

  def reconstruct(self, x, params=None, seed: int = 0):
    """(q(z|x), p(x|[E z, E z_y]))."""
    params = params or self._params_of()
    qz1, qz2 = self._encode_pair(x, params, seed)
    return qz1, self._core(params, "decode",
                           torch.cat([qz1.mean(), qz2.mean()], -1),
                           mutables=self._mutables())

  def predict_labels(self, x=None, latents=None, params=None, seed: int = 0):
    """p(y|z_y) at the posterior mean of z_y given x, or at `latents`
    (z_y)."""
    params = params or self._params_of()
    z2 = self._encode_pair(x, params, seed)[1].mean() if latents is None \
        else self._tensor(latents)
    return self.predict_factors(params, z2, mutables=self._mutables())


class semafoh(semafod):
  """Semafo with double hierarchical latents: z_y conditioned on [h, z]."""

  hierarchical_zy = True


class _CondDecodeCore(nn.Module):
  """The decoder takes [z, y]: y the true labels or the predicted ones."""

  decoder_takes_labels = True

  def __init__(self, encoder, decoder, latents, observation, labels):
    super().__init__()
    self.encoder, self.decoder = encoder, decoder
    self.latents, self.observation, self.labels = latents, observation, labels

  def build(self, input_shape, generator=None):
    z = self.latents.build(self.encoder.build(tuple(input_shape), generator),
                           generator)
    y = self.labels.build(z, generator)
    width = z[-1] + y[-1] if self.decoder_takes_labels else z[-1]
    self.observation.build(self.decoder.build((width,), generator),
                           generator)

  def encode(self, x):
    return self.latents(self.encoder(x))

  def decode_zy(self, z, y):
    return self.observation(self.decoder(torch.cat([z, y], -1)))

  def decode(self, z):
    """Generation: conditioned on the predicted labels."""
    return self.decode_zy(z, self.predict_labels(z).mean())

  def predict_labels(self, z):
    return self.labels(z)

  def forward(self, *args, method: str):
    return getattr(self, method)(*args)


class semafos(SemafoVAE):
  """Semafo with separated training steps and conditional decoding:
  p(x|z, y), y the true labels on the labelled rows and the (no-gradient)
  predicted ones elsewhere; the supervised term trains in its own
  ``TrainStep`` after the ELBO's, on the same partition and optimizer."""

  condition_on_labels = True

  def _build_core(self):
    return _CondDecodeCore(self.encoder_net, self.decoder_net,
                           self.latents_head, self.observation_head,
                           self.labels_head)

  def _decode_cond(self, params, z, py_z, y, mask, training, mutables,
                   noise):
    y_pred = py_z.mean().detach()
    if self.condition_on_labels and y is not None:
      m = mask.reshape(-1, 1) if mask is not None else torch.ones(
          (z.shape[0], 1), dtype=z.dtype, device=z.device)
      y_cond = m * y + (1 - m) * y_pred
    else:
      y_cond = y_pred
    return self._core(params, "decode_zy", z, y_cond, training=training,
                      mutables=mutables, noise=noise)

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y, mask = self._split_inputs(batch, mask=True)
    noise = as_noise(rng)
    qz = self._core(params, "encode", x, training=training,
                    mutables=mutables, noise=noise)
    z = qz.sample_from(noise)
    py_z = self.predict_factors(params, z, training, mutables, noise)
    px = self._decode_cond(params, z, py_z, y, mask, training, mutables,
                           noise)
    beta = self._schedule(self.beta, step)
    obs_name = self.core.observation.name or "observation"
    llk = {f"llk_{obs_name}": px.log_prob(x)}
    kl = {"kl_latents": beta * kl_divergence(
        qz, self._prior_on(z.device), analytic=self.analytic, q_sample=z,
        reverse=self.reverse, free_bits=self.free_bits)}
    mi_y, _ = self._mi_loss(params, qz, py_z, noise, step, training,
                            mutables)
    llk[f"mi_{self._labels_name}"] = mi_y * _ones(z)
    return llk, kl, dict(qz=qz, px=px, z=z, x=x, y=y, qy=py_z, mask=mask)

  def _supervised_loss(self, params, batch, rng, step, mutables):
    """The second step: the labelled rows' alpha-weighted labels
    log-likelihood."""
    x, y, mask = self._split_inputs(batch, mask=True)
    name = self._labels_name
    if y is None:
      zero = torch.zeros((), device=x.device)
      return zero, ({f"llk_{name}": zero}, mutables)
    noise = as_noise(rng)
    qz = self._core(params, "encode", x, training=True, mutables=mutables,
                    noise=noise)
    py_z = self.predict_factors(params, qz.sample_from(noise), True,
                                mutables, noise)
    llk_y = masked_mean_llk(self.alpha * py_z.log_prob(y), mask)
    return -torch.mean(llk_y), ({f"llk_{name}": torch.mean(llk_y)},
                                mutables)

  def train_steps(self):
    return [TrainStep(loss_fn=self._vae_loss, partitions=("vae",),
                      optimizer="vae", name="elbo"),
            TrainStep(loss_fn=self._supervised_loss, partitions=("vae",),
                      optimizer="vae", name="supervised")]

  def _mi_loss(self, params, qz, py_z, noise, step, training, mutables):
    """The MI term through the conditional decoder."""
    run = lambda method, *args: self._core(params, method, *args,
                                           training=training,
                                           mutables=mutables, noise=noise)
    z_prime = self._prior_on(py_z.mean().device).sample_from(
        noise, (qz.batch_shape[0],))
    py_prime = run("predict_labels", z_prime)
    px = run("decode_zy", z_prime, py_prime.mean().detach())
    qz_prime = run("encode", px.mean())
    qy_z = run("predict_labels", qz_prime.sample_from(noise))
    y_s = qy_z.sample_from(noise).detach()
    mi_y = self._gate(torch.mean(qy_z.log_prob(y_s) -
                                 py_prime.log_prob(y_s)), step, training)
    return self.mi_coef(step) * mi_y, torch.zeros(())

  def reconstruct(self, x, params=None):
    """(q(z|x), p(x|E z, E p(y|E z)))."""
    params = params or self._params_of()
    qz = self.encode(x, params)
    return qz, self._apply(params, "decode", qz.mean(),
                           mutables=self._mutables())


class _MultitaskDecodeCore(_CondDecodeCore):
  """The decoder takes z alone; y is a side task (semafosm)."""

  decoder_takes_labels = False

  def decode_zy(self, z, y):
    return self.observation(self.decoder(z))

  def decode(self, z):
    return self.observation(self.decoder(z))


class semafosm(semafos):
  """Separated steps, multi-task decoding: p(x|z), y predicted aside."""

  def _build_core(self):
    return _MultitaskDecodeCore(self.encoder_net, self.decoder_net,
                                self.latents_head, self.observation_head,
                                self.labels_head)


class semafosc(semafos):
  """Separated steps, simple conditioning: the decoder always takes the
  (no-gradient) predicted labels, never the true ones."""

  condition_on_labels = False


class semafop(SemafoVAE):
  """Semafo minimising the divergence between the unlabelled and the
  labelled rows directly: the mask-weighted difference of the two groups'
  mean log p(y~|z) at labels drawn from p(y|z)."""

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y, mask = self._split_inputs(batch, mask=True)
    noise = as_noise(rng)
    llk, kl, aux = AnnealingVAE.elbo_components(self, params, x, noise, step,
                                                training=training,
                                                mutables=mutables)
    z = aux["z"]
    py_z = self.predict_factors(params, z, training, mutables, noise)
    aux["qy"] = py_z
    name = self._labels_name
    if y is not None:
      llk[f"llk_{name}"] = masked_mean_llk(self.alpha * py_z.log_prob(y),
                                           mask)
      lp = py_z.log_prob(py_z.sample_from(noise).detach())
      m = mask.reshape(-1) if mask is not None else torch.ones_like(lp)
      n_u = torch.clamp(torch.sum(1 - m), min=1.0)
      n_l = torch.clamp(torch.sum(m), min=1.0)
      kl[f"kl_{name}"] = self.mi_coef(step) * (
          torch.sum(lp * (1 - m)) / n_u - torch.sum(lp * m) / n_l) \
          * _ones(z) / z.shape[0]
    return llk, kl, aux


class semafot(SemafoVAE):
  """Semafo with a longer MI warm-up (5,000 steps)."""

  def __init__(self, steps_without_mi: int = 5000, **kwargs):
    kwargs.pop("steps_without_mi", None)
    super().__init__(steps_without_mi=steps_without_mi, **kwargs)
