"""VAEs of grouped (paired) observations of the port (PyTorch port of
``odin_tpu/bay/vi/autoencoder/self_supervised_vae.py``): ``GroupVAE``
(Hosoya 2019), ``MultiLevelVAE`` (Bouchacourt et al. 2018), ``AdaptiveVAE``
(Ada-GVAE / Ada-ML-VAE, Locatello et al. 2020) and ``WeaklySupervisedVAE``
(Shu et al. 2020: ``match``, ``rank`` and ``restricted``).

A batch is a pair: a tuple ``(x1, x2)`` with an optional label as its
third element, or one tensor stacked as ``(B, 2, ...)``.  A second element
shaped unlike x1 is a label, not a partner; an unpaired batch (the Gym's)
falls back to the vanilla per-sample ELBO.  Both members go through one
encode and one decode of ``2B`` rows; the shared dimensions are a mask of
elementwise ``where``s, with no data-dependent shape.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from odin_tpu_torch.bay.distributions import MultivariateNormalDiag
from odin_tpu_torch.bay.helpers import kl_divergence
from odin_tpu_torch.bay.vi.autoencoder.variational_autoencoder import (
    VariationalAutoencoder,
)
from odin_tpu_torch.training.core import as_noise

__all__ = ["GroupVAE", "MultiLevelVAE", "AdaptiveVAE", "WeaklySupervisedVAE"]


def _moments(qz):
  try:
    return qz.mean(), qz.stddev()
  except Exception as e:
    raise ValueError(
        "grouped-observation VAEs require a Gaussian-family posterior "
        f"(got {type(qz).__name__})") from e


def _aggregate(m1, s1, m2, s2, how: str):
  """Two diagonal Gaussian posteriors aggregated (Locatello 2020, §3):
  'group' averages their moments, 'multilevel' is their product of
  experts; -> (mean, stddev)."""
  if how == "group":
    m = 0.5 * (m1 + m2)
    v = 0.5 * (s1 ** 2 + s2 ** 2)
  elif how == "multilevel":
    p1, p2 = 1.0 / (s1 ** 2), 1.0 / (s2 ** 2)
    v = 1.0 / (p1 + p2)
    m = v * (m1 * p1 + m2 * p2)
  else:
    raise ValueError(f"unknown aggregation '{how}'")
  return m, torch.sqrt(v)


def _sym_kl_per_dim(m1, s1, m2, s2):
  """The symmetric KL of two diagonal Gaussians, per dimension."""
  v1, v2 = s1 ** 2, s2 ** 2
  d2 = (m1 - m2) ** 2
  kl12 = torch.log(s2 / s1) + (v1 + d2) / (2.0 * v2) - 0.5
  kl21 = torch.log(s1 / s2) + (v2 + d2) / (2.0 * v1) - 0.5
  return 0.5 * (kl12 + kl21)


class GroupVAE(VariationalAutoencoder):
  """Group-based disentanglement on pairs (Hosoya 2019): the first
  `n_shared` latent dimensions (zdim // 2 by default) are content shared
  within the pair, their posteriors averaged; the rest is per-sample
  style.  `beta` scales the KL.  The aux dict of ``elbo_components``
  holds ``n_shared``, the batch's mean count of shared dimensions."""

  aggregation = "group"

  def __init__(self, n_shared: Optional[int] = None, beta: float = 1.0,
               **kwargs):
    super().__init__(**kwargs)
    self.n_shared = n_shared
    self.beta = float(beta)

  def _split_pair(self, batch):
    """-> (x1, x2 or None, label or None)."""
    if isinstance(batch, (tuple, list)):
      x1 = batch[0]
      x2 = batch[1] if len(batch) > 1 else None
      y = batch[2] if len(batch) > 2 else None
      if x2 is not None and tuple(x2.shape) != tuple(x1.shape):
        return x1, None, x2  # the second element is a label, not a partner
      return x1, x2, y
    x = batch
    if self.input_shape is not None and \
        x.ndim == len(self.input_shape) + 2 and x.shape[1] == 2:
      return x[:, 0], x[:, 1], None
    return x, None, None

  def _shared_mask(self, m1, s1, m2, s2, y=None):
    """(B, zdim) float mask, 1 where the pair shares the dimension."""
    k = self.n_shared if self.n_shared is not None else m1.shape[-1] // 2
    mask = torch.zeros_like(m1)
    mask[..., :k] = 1.0
    return mask

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x1, x2, y = self._split_pair(batch)
    if x2 is None:  # unpaired: the vanilla ELBO (evaluation paths)
      return super().elbo_components(params, x1 if y is None else (x1, y),
                                     rng, step, training=training,
                                     mutables=mutables)
    noise = as_noise(rng)
    qz = self._apply(params, "encode", torch.cat([x1, x2], 0), training,
                     mutables, noise)
    m, s = _moments(qz)
    B = x1.shape[0]
    m1, m2, s1, s2 = m[:B], m[B:], s[:B], s[B:]
    mask = self._shared_mask(m1, s1, m2, s2, y)
    ma, sa = _aggregate(m1, s1, m2, s2, self.aggregation)
    shared = mask > 0
    q1 = MultivariateNormalDiag(torch.where(shared, ma, m1),
                                torch.where(shared, sa, s1))
    q2 = MultivariateNormalDiag(torch.where(shared, ma, m2),
                                torch.where(shared, sa, s2))
    z1 = q1.sample_from(noise)
    z2 = q2.sample_from(noise)
    px = self._apply(params, "decode", torch.cat([z1, z2], 0), training,
                     mutables, noise)
    llk_pair = px.log_prob(torch.cat([x1, x2], 0))
    llk = {"llk_observation": 0.5 * (llk_pair[:B] + llk_pair[B:])}
    prior = self._prior_on(z1.device)
    kl1, kl2 = (kl_divergence(q, prior, analytic=self.analytic,
                              q_sample=z if not self.analytic else None,
                              reverse=self.reverse, free_bits=self.free_bits)
                for q, z in ((q1, z1), (q2, z2)))
    kl = {"kl_latents": self.beta * 0.5 * (kl1 + kl2)}
    aux = dict(qz=q1, px=px, z=z1, x=x1, y=y,
               n_shared=torch.mean(torch.sum(mask, -1)))
    extra = self._pair_regularizer(m1, m2, z1, z2, y)
    if extra is not None:
      kl["pair_loss"] = extra
    return llk, kl, aux

  def _pair_regularizer(self, m1, m2, z1, z2, y):
    return None


class MultiLevelVAE(GroupVAE):
  """Multi-Level VAE (Bouchacourt et al. 2018): the shared block
  aggregated as a product of experts."""

  aggregation = "multilevel"


class AdaptiveVAE(GroupVAE):
  """Ada-GVAE / Ada-ML-VAE (Locatello et al. 2020): a dimension is shared
  where the pair's per-dimension symmetric KL is below ``(max + min) / 2``
  of the row; aggregation by `base_method` ('group'/'g' or
  'multilevel'/'ml')."""

  def __init__(self, base_method: str = "group", **kwargs):
    kwargs.pop("n_shared", None)
    super().__init__(n_shared=None, **kwargs)
    base_method = {"g": "group", "ml": "multilevel"}.get(
        str(base_method).lower(), str(base_method).lower())
    if base_method not in ("group", "multilevel"):
      raise ValueError("base_method must be 'group'/'g' or 'multilevel'/'ml'")
    self.aggregation = base_method

  def _shared_mask(self, m1, s1, m2, s2, y=None):
    delta = _sym_kl_per_dim(m1, s1, m2, s2)
    tau = 0.5 * (delta.amax(-1, keepdim=True) + delta.amin(-1, keepdim=True))
    return (delta < tau).to(m1.dtype)


class WeaklySupervisedVAE(GroupVAE):
  """Weakly supervised disentanglement (Shu et al. 2020), by `strategy`:

    - 'match': the pair shares ``zdim - n_changed`` factors; the
      dimensions of lowest symmetric KL are aggregated (ranked by a stable
      sort, as ``jnp.argsort``);
    - 'rank': y in {0, 1} says whether member 1 has the larger value of
      the ranked factor: ``rank_weight * softplus(-(z1_d - z2_d)(2y - 1))``
      on dimension `rank_dim`;
    - 'restricted': y holds observed factor values, tied to the first
      ``y.shape[-1]`` posterior means by ``label_weight`` times a squared
      error.
  The supervision is the KL term ``pair_loss``."""

  def __init__(self, strategy: str = "rank", n_changed: int = 1,
               rank_dim: int = 0, rank_weight: float = 1.0,
               label_weight: float = 10.0, **kwargs):
    kwargs.pop("n_shared", None)
    super().__init__(n_shared=None, **kwargs)
    strategy = str(strategy).lower()
    if strategy not in ("match", "rank", "restricted"):
      raise ValueError("strategy must be 'match', 'rank' or 'restricted'")
    self.strategy = strategy
    self.n_changed = int(n_changed)
    self.rank_dim = int(rank_dim)
    self.rank_weight = float(rank_weight)
    self.label_weight = float(label_weight)

  def _shared_mask(self, m1, s1, m2, s2, y=None):
    if self.strategy != "match":
      return torch.zeros_like(m1)  # supervision through pair_loss alone
    delta = _sym_kl_per_dim(m1, s1, m2, s2)
    k_shared = max(m1.shape[-1] - self.n_changed, 0)
    order = torch.argsort(delta, dim=-1, stable=True)  # most similar first
    ranks = torch.argsort(order, dim=-1, stable=True)
    return (ranks < k_shared).to(m1.dtype)

  def _pair_regularizer(self, m1, m2, z1, z2, y):
    if self.strategy == "rank":
      if y is None:
        return None
      sign = 2.0 * y.reshape(-1).to(m1.dtype) - 1.0
      diff = (z1[..., self.rank_dim] - z2[..., self.rank_dim]) * sign
      return self.rank_weight * F.softplus(-diff)
    if self.strategy == "restricted" and y is not None:
      y = y.reshape(y.shape[0], -1).to(m1.dtype)
      d = min(y.shape[-1], m1.shape[-1])
      se1 = torch.sum((m1[..., :d] - y[..., :d]) ** 2, -1)
      se2 = torch.sum((m2[..., :d] - y[..., :d]) ** 2, -1)
      return self.label_weight * 0.25 * (se1 + se2)
    return None
