"""Sequential VAEs of the port (PyTorch port of
``odin_tpu/bay/vi/autoencoder/sequential_vae.py``): ``VariationalRNN``
(``_VRNNCell`` and ``VRNNCore``, :43-211), ``SequentialVAE`` (the
Disentangled Sequential Autoencoder, :213-351) and
``SequentialAttentionVAE`` (:353-521).

Batches are (B, T, D) float sequences; `input_shape` is (T, D).  The JAX
package runs each recurrence as one ``nn.scan``; here it is a Python loop
over T (inside a captured CUDA graph on the card), the GRU a
``networks.GRUCell`` (flax's cell as ``torch.gru_cell``).  Only what the
recurrence needs runs in the loop: every head that reads the recurrent
state without feeding it (the VRNN's prior and emission, the DSA's prior
head, SAVAE's emission) runs once over (B, T) after it, the same
function as JAX's per-step heads.  A draw inside the loop takes the next
draw of the ``Noise`` of the call (``layer_noise()``), as JAX's scan
splits its ``sample`` key per step.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from odin_tpu_torch.bay.distributions import MultivariateNormalDiag
from odin_tpu_torch.bay.helpers import kl_divergence, map_distributions
from odin_tpu_torch.bay.layers.dense_distribution import DistributionDense
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    VariationalAutoencoder,
)
from odin_tpu_torch.networks.attention import Attention
from odin_tpu_torch.networks.base import Dense, GRUCell, layer_noise
from odin_tpu_torch.training.core import Noise, as_noise

__all__ = ["VariationalRNN", "SequentialVAE", "SequentialAttentionVAE"]


def _noise() -> Noise:
  noise = layer_noise()
  if noise is None:
    raise ValueError("a sequential model draws: call it with noise")
  return noise


def _stack(dists):
  """Per-step distributions (B, ...) -> one over (B, T, ...)."""
  return map_distributions(lambda *t: torch.stack(t, 1), *dists)


def _gru_scan(gru: GRUCell, h, xs):
  """The GRU over xs (B, T, in) from h: the states (B, T, H)."""
  w = gru.weights()
  out = []
  for t in range(xs.shape[1]):
    h = gru(h, xs[:, t], w)
    out.append(h)
  return torch.stack(out, 1)


class _VRNNCell(nn.Module):
  """The VRNN's modules (flax's scanned cell ``cell``): ``feat_x``,
  ``feat_z``, the ``posterior``, ``prior`` and ``observation`` heads and
  the ``gru``."""

  def __init__(self, zdim: int, hidden: int, feat_units: int,
               obs_event: Tuple[int, ...], obs_posterior: str = "gaussian",
               latent_posterior: str = "mvndiag"):
    super().__init__()
    self.zdim, self.hidden, self.feat_units = zdim, hidden, feat_units
    self.feat_x = Dense(feat_units, bare=True)
    self.feat_z = Dense(feat_units, bare=True)
    self.posterior = DistributionDense((zdim,), latent_posterior,
                                       name="posterior")
    self.prior = DistributionDense((zdim,), latent_posterior, name="prior")
    self.observation = DistributionDense(tuple(obs_event), obs_posterior,
                                         name="observation")
    self.gru = GRUCell(hidden)

  def build(self, x_shape, generator=None):
    f, h = self.feat_units, self.hidden
    self.feat_x.build((int(x_shape[-1]),), generator)
    self.feat_z.build((self.zdim,), generator)
    self.posterior.build((f + h,), generator)
    self.prior.build((h,), generator)
    self.observation.build((f + h,), generator)
    self.gru.build((2 * f,), generator)

  def emit(self, phi_z, h, w):
    """One closed-loop step of 'decode' and 'generate': px_t, and the
    state after feeding px_t's mean back."""
    px = self.observation(torch.cat([phi_z, h], -1))
    phi_x = F.relu(self.feat_x(px.mean().reshape(phi_z.shape[0], -1)))
    return px, self.gru(h, torch.cat([phi_x, phi_z], -1), w)


class VRNNCore(nn.Module):
  """The VRNN over a sequence: 'filter' (``elbo_scan``), 'decode' from
  given latents and 'generate' from the learned prior."""

  def __init__(self, zdim: int, hidden: int, feat_units: int,
               obs_event: Tuple[int, ...], obs_posterior: str = "gaussian",
               latent_posterior: str = "mvndiag"):
    super().__init__()
    self.hidden = int(hidden)
    self.cell = _VRNNCell(zdim, hidden, feat_units, obs_event, obs_posterior,
                          latent_posterior)

  @property
  def latents(self) -> nn.Module:
    return self.cell.posterior

  @property
  def observation(self) -> nn.Module:
    return self.cell.observation

  def build(self, input_shape, generator=None):
    self.cell.build(tuple(input_shape), generator)

  def _h0(self, x):
    return torch.zeros(x.shape[0], self.hidden, dtype=x.dtype,
                       device=x.device)

  def elbo_scan(self, x):
    """(qz, pz, px, z), time on axis 1."""
    cell, noise = self.cell, _noise()
    phi_x = F.relu(cell.feat_x(x))
    w = cell.gru.weights()
    h = self._h0(x)
    hs, qs, zs, phis = [], [], [], []
    for t in range(x.shape[1]):
      qz = cell.posterior(torch.cat([phi_x[:, t], h], -1))
      z = qz.sample_from(noise)
      phi_z = F.relu(cell.feat_z(z))
      hs.append(h)
      qs.append(qz)
      zs.append(z)
      phis.append(phi_z)
      h = cell.gru(h, torch.cat([phi_x[:, t], phi_z], -1), w)
    h_prev = torch.stack(hs, 1)
    pz = cell.prior(h_prev)
    px = cell.observation(torch.cat([torch.stack(phis, 1), h_prev], -1))
    return _stack(qs), pz, px, torch.stack(zs, 1)

  def encode(self, x):
    return self.elbo_scan(x)[0]

  def decode(self, z):
    cell, w = self.cell, self.cell.gru.weights()
    h, pxs = self._h0(z), []
    for t in range(z.shape[1]):
      px, h = cell.emit(F.relu(cell.feat_z(z[:, t])), h, w)
      pxs.append(px)
    return _stack(pxs)

  def generate(self, dummy):
    """dummy (B, T, 1) fixes the number of steps: (px, z)."""
    cell, noise, w = self.cell, _noise(), self.cell.gru.weights()
    h, pxs, zs = self._h0(dummy), [], []
    for _ in range(dummy.shape[1]):
      z = cell.prior(h).sample_from(noise)
      px, h = cell.emit(F.relu(cell.feat_z(z)), h, w)
      pxs.append(px)
      zs.append(z)
    return _stack(pxs), torch.stack(zs, 1)

  def forward(self, *args, method: Optional[str] = None):
    if method is not None:
      return getattr(self, method)(*args)
    qz, _, px, _ = self.elbo_scan(args[0])
    return px, qz


class _SequenceVAE(VariationalAutoencoder):
  """What the three sequential models share: a per-step Gaussian emission
  by default, and encode/decode that draw from a generator seeded
  `seed` (the time axis is no sample axis)."""

  def __init__(self, latents_size: int, latents: Any = None,
               observation: Any = None,
               input_shape: Optional[Tuple[int, ...]] = None, **kwargs):
    if latents is None:
      latents = RVconf(latents_size, "mvndiag", projection=True,
                       name="latents")
    if observation is None and input_shape is not None:
      observation = RVconf((input_shape[-1],), "gaussian", projection=True,
                           name="observation")
    kwargs.pop("encoder", None)
    kwargs.pop("decoder", None)
    super().__init__(encoder=None, decoder=None, latents=latents,
                     observation=observation, input_shape=input_shape,
                     **kwargs)

  def _head_args(self):
    return dict(obs_event=tuple(self.observation_head.event_shape),
                obs_posterior=self.observation_head.posterior,
                latent_posterior=self.latents_head.posterior)

  @property
  def zdim(self) -> int:
    return int(np.prod(self.latents_head.event_shape))

  def encode(self, x, params=None, seed: int = 0):
    return self._apply(params or self._params_of(), "encode",
                       self._tensor(x), mutables=self._mutables(),
                       noise=Noise(self._generator(seed)))

  def decode(self, z, params=None, seed: int = 0):
    """z (B, T, zdim) -> px (B, T, ...)."""
    return self._apply(params or self._params_of(), "decode",
                       self._tensor(z), mutables=self._mutables(),
                       noise=Noise(self._generator(seed)))


class VariationalRNN(_SequenceVAE):
  """VRNN (Chung et al. 2015): per-step latents z_t with the learned
  recurrent prior ``p(z_t | h_{t-1})``, posterior ``q(z_t | x_t,
  h_{t-1})``, emission ``p(x_t | z_t, h_{t-1})`` and the GRU recurrence;
  the KL is ``sum_t KL(q(z_t) || p(z_t))``."""

  def __init__(self, rnn_units: int = 64, feature_units: int = 64,
               latents: Any = None, observation: Any = None,
               input_shape: Optional[Tuple[int, ...]] = None, **kwargs):
    self.rnn_units = int(rnn_units)
    self.feature_units = int(feature_units)
    super().__init__(16, latents, observation, input_shape, **kwargs)

  def _build_core(self) -> nn.Module:
    return VRNNCore(self.zdim, self.rnn_units, self.feature_units,
                    **self._head_args())

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y = self._split_inputs(batch)
    qz, pz, px, z = self._apply(params, "elbo_scan", x, training, mutables,
                                as_noise(rng))
    llk = {"llk_observation": torch.sum(px.log_prob(x), dim=-1)}
    kl_t = kl_divergence(qz, pz, analytic=self.analytic,
                         q_sample=z if not self.analytic else None,
                         reverse=self.reverse, free_bits=self.free_bits)
    kl = {"kl_latents": torch.sum(kl_t, dim=-1)}
    return llk, kl, dict(qz=qz, px=px, z=z, x=x, y=y)

  @torch.no_grad()
  def generate(self, n: int = 1, n_steps: Optional[int] = None,
               params=None, seed: int = 0):
    """n new sequences unrolled from the learned prior: (px, z)."""
    n_steps = self.input_shape[0] if n_steps is None else int(n_steps)
    dummy = torch.zeros(n, n_steps, 1, device=self.device)
    return self._apply(params or self._params_of(), "generate", dummy,
                       mutables=self._mutables(),
                       noise=Noise(self._generator(seed)))


class _DSAPriorCell(nn.Module):
  """The DSA's dynamic prior ``p(z_t | z_<t)`` (flax's scanned
  ``dynamic_prior``): a ``gru`` and a ``prior`` head."""

  def __init__(self, zdim: int, hidden: int,
               latent_posterior: str = "mvndiag"):
    super().__init__()
    self.gru = GRUCell(hidden)
    self.prior = DistributionDense((zdim,), latent_posterior, name="prior")


class DSACore(nn.Module):
  """Disentangled Sequential Autoencoder trunk (Li & Mandt 2018): the
  static posterior ``q(f | x_1..T)`` from mean-pooled step features, the
  factorised dynamic posterior ``q(z_t | x_t, f)``, the learned dynamic
  prior over the sampled path, and the emission ``p(x_t | z_t, f)``."""

  def __init__(self, zdim: int, fdim: int, hidden: int, feat_units: int,
               obs_event: Tuple[int, ...], obs_posterior: str = "gaussian",
               latent_posterior: str = "mvndiag"):
    super().__init__()
    self.zdim, self.fdim, self.hidden = zdim, fdim, hidden
    self.feat_units = feat_units
    self.feat_x = Dense(feat_units, bare=True)
    self.static_posterior = DistributionDense((fdim,), latent_posterior,
                                              name="static_posterior")
    self.dynamic_posterior = DistributionDense((zdim,), latent_posterior,
                                               name="dynamic_posterior")
    self.observation = DistributionDense(tuple(obs_event), obs_posterior,
                                         name="observation")
    self.dynamic_prior = _DSAPriorCell(zdim, hidden, latent_posterior)

  @property
  def latents(self) -> nn.Module:
    return self.dynamic_posterior

  def build(self, input_shape, generator=None):
    f = self.feat_units
    self.feat_x.build((int(input_shape[-1]),), generator)
    self.static_posterior.build((f,), generator)
    self.dynamic_posterior.build((f + self.fdim,), generator)
    self.observation.build((self.zdim + self.fdim,), generator)
    self.dynamic_prior.gru.build((self.zdim,), generator)
    self.dynamic_prior.prior.build((self.hidden,), generator)

  def _seq(self, f, like):
    return f[:, None, :].expand(like.shape[0], like.shape[1], f.shape[-1])

  def elbo_scan(self, x):
    noise = _noise()
    phi = F.relu(self.feat_x(x))
    qf = self.static_posterior(phi.mean(dim=1))
    f = qf.sample_from(noise)
    f_seq = self._seq(f, phi)
    qz = self.dynamic_posterior(torch.cat([phi, f_seq], -1))
    z = qz.sample_from(noise)
    z_prev = torch.cat([torch.zeros_like(z[:, :1]), z[:, :-1]], dim=1)
    h0 = torch.zeros(x.shape[0], self.hidden, dtype=x.dtype, device=x.device)
    pz = self.dynamic_prior.prior(_gru_scan(self.dynamic_prior.gru, h0,
                                            z_prev))
    px = self.observation(torch.cat([z, f_seq], -1))
    return qf, f, qz, pz, px, z

  def encode(self, x):
    phi = F.relu(self.feat_x(x))
    f = self.static_posterior(phi.mean(dim=1)).mean()
    return self.dynamic_posterior(torch.cat([phi, self._seq(f, phi)], -1))

  def decode(self, z, f=None):
    if f is None:
      f = torch.zeros(z.shape[0], self.fdim, dtype=z.dtype, device=z.device)
    return self.observation(torch.cat([z, self._seq(f, z)], -1))

  def forward(self, *args, method: Optional[str] = None):
    if method is not None:
      return getattr(self, method)(*args)
    _, _, qz, _, px, _ = self.elbo_scan(args[0])
    return px, qz


class SequentialVAE(_SequenceVAE):
  """Disentangled Sequential Autoencoder (Li & Mandt 2018): ``ELBO =
  sum_t llk_t - KL(f) - sum_t KL(z_t || p(z_t | z_<t))``; `fdim` sizes the
  static latent, the `latents` RVconf the per-step dynamic one."""

  def __init__(self, fdim: int = 16, rnn_units: int = 64,
               feature_units: int = 64, latents: Any = None,
               observation: Any = None,
               input_shape: Optional[Tuple[int, ...]] = None, **kwargs):
    self.fdim = int(fdim)
    self.rnn_units = int(rnn_units)
    self.feature_units = int(feature_units)
    super().__init__(8, latents, observation, input_shape, **kwargs)
    self._static_prior = RVconf(self.fdim, "mvndiag").create_prior()
    self._static_priors = {}

  def _build_core(self) -> nn.Module:
    return DSACore(self.zdim, self.fdim, self.rnn_units, self.feature_units,
                   **self._head_args())

  def _static_prior_on(self, device):
    if device not in self._static_priors:
      self._static_priors[device] = map_distributions(
          lambda t: t.to(device), self._static_prior)
    return self._static_priors[device]

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y = self._split_inputs(batch)
    qf, f, qz, pz, px, z = self._apply(params, "elbo_scan", x, training,
                                       mutables, as_noise(rng))
    llk = {"llk_observation": torch.sum(px.log_prob(x), dim=-1)}
    kl_f = kl_divergence(qf, self._static_prior_on(f.device),
                         analytic=self.analytic,
                         q_sample=f if not self.analytic else None,
                         reverse=self.reverse, free_bits=self.free_bits)
    kl_t = kl_divergence(qz, pz, analytic=self.analytic,
                         q_sample=z if not self.analytic else None,
                         reverse=self.reverse, free_bits=self.free_bits)
    kl = {"kl_static": kl_f, "kl_dynamic": torch.sum(kl_t, dim=-1)}
    return llk, kl, dict(qz=qz, qf=qf, px=px, z=z, x=x, y=y)


class _VarAttnCell(nn.Module):
  """The variational-attention decoder's modules (flax's scanned
  ``decoder``): ``query``, ``context_log_scale``, the ``observation``
  head, the ``gru`` and the ``attn`` layer.  A step's attention context
  is a Gaussian latent (Bahuleyan et al. 2017): its mean the dot-product
  attention over the encoder states, its scale from the state."""

  def __init__(self, hidden: int, obs_event: Tuple[int, ...],
               obs_posterior: str = "gaussian", attn_score: str = "dot",
               attn_position: str = "global", attn_align: str = "soft",
               attn_window: int = 8):
    super().__init__()
    self.hidden = int(hidden)
    self.query = Dense(hidden, bare=True)
    self.context_log_scale = Dense(hidden, bare=True)
    self.observation = DistributionDense(tuple(obs_event), obs_posterior,
                                         name="observation")
    self.gru = GRUCell(hidden)
    self.attn = Attention(score=attn_score, position=attn_position,
                          align=attn_align, window=attn_window)


class SAVAECore(nn.Module):
  """Encoder GRU -> states; a global latent z from the last state; the
  variational-attention decoder, teacher-forced (step t reads x_{t-1})."""

  def __init__(self, zdim: int, hidden: int, obs_event: Tuple[int, ...],
               obs_posterior: str = "gaussian",
               latent_posterior: str = "mvndiag", decode_steps: int = 1,
               attn_score: str = "dot", attn_position: str = "global",
               attn_align: str = "soft", attn_window: int = 8):
    super().__init__()
    self.zdim, self.hidden = int(zdim), int(hidden)
    self.obs_event = tuple(obs_event)
    self.decode_steps = int(decode_steps)
    self.encoder_rnn = GRUCell(hidden)
    self.latents = DistributionDense((zdim,), latent_posterior,
                                     name="latents")
    self.decoder = _VarAttnCell(hidden, obs_event, obs_posterior, attn_score,
                                attn_position, attn_align, attn_window)

  @property
  def observation(self) -> nn.Module:
    return self.decoder.observation

  def build(self, input_shape, generator=None):
    t, d = (int(i) for i in input_shape)
    h, dec = self.hidden, self.decoder
    self.encoder_rnn.build((d,), generator)
    self.latents.build((h,), generator)
    dec.query.build((h + self.zdim,), generator)
    dec.context_log_scale.build((h,), generator)
    dec.observation.build((2 * h + self.zdim,), generator)
    dec.gru.build((int(np.prod(self.obs_event)) + h,), generator)
    dec.attn.build((1, h), generator, k_shape=(t, h))

  def _states(self, x):
    h0 = torch.zeros(x.shape[0], self.hidden, dtype=x.dtype, device=x.device)
    return _gru_scan(self.encoder_rnn, h0, x)

  def _decode_loop(self, x_prev, states, z, noise):
    """(px, qc, c) of the decoder over x_prev (B, T, ...), time on axis 1."""
    dec = self.decoder
    w = dec.gru.weights()
    h = torch.zeros(z.shape[0], self.hidden, dtype=z.dtype, device=z.device)
    hs, means, scales, cs = [], [], [], []
    for t in range(x_prev.shape[1]):
      q = dec.query(torch.cat([h, z], -1))
      ctx, _ = dec.attn(q[:, None], states)
      c_mean = ctx[:, 0]
      c_scale = F.softplus(dec.context_log_scale(h)) + 1e-4
      c = MultivariateNormalDiag(c_mean, c_scale).sample_from(noise)
      hs.append(h)
      means.append(c_mean)
      scales.append(c_scale)
      cs.append(c)
      h = dec.gru(h, torch.cat([x_prev[:, t].reshape(z.shape[0], -1), c],
                               -1), w)
    c = torch.stack(cs, 1)
    z_seq = z[:, None, :].expand(z.shape[0], c.shape[1], z.shape[-1])
    px = dec.observation(torch.cat([torch.stack(hs, 1), c, z_seq], -1))
    qc = MultivariateNormalDiag(torch.stack(means, 1), torch.stack(scales, 1))
    return px, qc, c

  def encode(self, x):
    return self.latents(self._states(x)[:, -1])

  def elbo_scan(self, x):
    noise = _noise()
    states = self._states(x)
    qz = self.latents(states[:, -1])
    z = qz.sample_from(noise)
    x_prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    px, qc, c = self._decode_loop(x_prev, states, z, noise)
    return qz, z, qc, c, px

  def decode(self, z, n_steps: Optional[int] = None):
    """A free-running decode from the global latent alone: the attention
    memory is one zero state, `n_steps` (the sequence length the model was
    made for by default) steps of zero input."""
    n = z.shape[0]
    states = torch.zeros(n, 1, self.hidden, dtype=z.dtype, device=z.device)
    t = self.decode_steps if n_steps is None else int(n_steps)
    x_prev = torch.zeros((n, t) + self.obs_event, dtype=z.dtype,
                         device=z.device)
    return self._decode_loop(x_prev, states, z, _noise())[0]

  def forward(self, *args, method: Optional[str] = None):
    if method is not None:
      return getattr(self, method)(*args)
    qz, _, _, _, px = self.elbo_scan(args[0])
    return px, qz


class SequentialAttentionVAE(_SequenceVAE):
  """Variational-attention seq2seq autoencoder (Deng et al. 2018;
  Bahuleyan et al. 2017): a global latent z and per-step Gaussian
  attention contexts c_t with an N(0, I) prior; ``ELBO = sum_t llk_t -
  KL(z) - attn_beta * sum_t KL(c_t)``."""

  def __init__(self, rnn_units: int = 64, attn_beta: float = 0.1,
               latents: Any = None, observation: Any = None,
               input_shape: Optional[Tuple[int, ...]] = None,
               attn_score: str = "dot", attn_position: str = "global",
               attn_align: str = "soft", attn_window: int = 8, **kwargs):
    self.rnn_units = int(rnn_units)
    self.attn_beta = float(attn_beta)
    self.attn_score = str(attn_score)
    self.attn_position = str(attn_position)
    self.attn_align = str(attn_align)
    self.attn_window = int(attn_window)
    self._decode_steps = int(input_shape[0]) if input_shape else 1
    super().__init__(16, latents, observation, input_shape, **kwargs)
    self._context_prior = RVconf(self.rnn_units, "mvndiag").create_prior()
    self._context_priors = {}

  def _build_core(self) -> nn.Module:
    args = self._head_args()
    return SAVAECore(self.zdim, self.rnn_units, args["obs_event"],
                     args["obs_posterior"], args["latent_posterior"],
                     self._decode_steps, self.attn_score, self.attn_position,
                     self.attn_align, self.attn_window)

  def _context_prior_on(self, device):
    if device not in self._context_priors:
      self._context_priors[device] = map_distributions(
          lambda t: t.to(device), self._context_prior)
    return self._context_priors[device]

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y = self._split_inputs(batch)
    qz, z, qc, c, px = self._apply(params, "elbo_scan", x, training,
                                   mutables, as_noise(rng))
    llk = {"llk_observation": torch.sum(px.log_prob(x), dim=-1)}
    kl_z = kl_divergence(qz, self._prior_on(z.device),
                         analytic=self.analytic,
                         q_sample=z if not self.analytic else None,
                         reverse=self.reverse, free_bits=self.free_bits)
    kl_c = kl_divergence(qc, self._context_prior_on(c.device),
                         analytic=self.analytic,
                         q_sample=c if not self.analytic else None,
                         reverse=self.reverse, free_bits=self.free_bits)
    kl = {"kl_latents": kl_z,
          "kl_attention": self.attn_beta * torch.sum(kl_c, dim=-1)}
    return llk, kl, dict(qz=qz, px=px, z=z, x=x, y=y)
