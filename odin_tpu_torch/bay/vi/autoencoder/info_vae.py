"""InfoVAE and MIVAE of the port (PyTorch port of
``odin_tpu/bay/vi/autoencoder/info_vae.py``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from odin_tpu_torch.bay.distributions import MultivariateNormalDiag
from odin_tpu_torch.bay.helpers import kl_divergence
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.bay.vi.autoencoder.beta_vae import BetaVAE
from odin_tpu_torch.bay.vi.losses import maximum_mean_discrepancy
from odin_tpu_torch.training.core import as_noise

__all__ = ["InfoVAE", "MIVAE"]


class InfoVAE(BetaVAE):
  """InfoVAE (Zhao et al.): ``ELBO = llk - beta kl - (lamda - beta)
  MMD(q(z) || p(z))`` with beta = 1 - alpha; the MMD against
  `n_prior_samples` prior draws.  The paper's MNIST setting is lamda 1000,
  alpha 0."""

  def __init__(self,
               alpha: float = 0.0,
               lamda: float = 100.0,
               divergence: str = "mmd",
               n_prior_samples: int = 100,
               **kwargs):
    kwargs.pop("beta", None)
    super().__init__(beta=1.0 - alpha, **kwargs)
    self.lamda = float(lamda)
    self.divergence = divergence
    self.n_prior_samples = int(n_prior_samples)

  @property
  def alpha(self):
    return 1.0 - self.beta

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    noise = as_noise(rng)
    llk, kl, aux = super().elbo_components(params, batch, noise, step,
                                           training=training,
                                           mutables=mutables)
    z = aux["z"].reshape(-1, self.zdim)
    div = maximum_mean_discrepancy(aux["qz"], self._prior_on(z.device),
                                   noise, q_samples=z,
                                   p_sample_shape=self.n_prior_samples)
    beta = self._schedule(self.beta, step)
    kl["div_latents"] = (self.lamda - beta) * div * torch.ones(
        z.shape[0], dtype=z.dtype, device=z.device)
    return llk, kl, aux


class MIVAE(BetaVAE):
  """Mutual-information VAE: decode a prior draw (z', c'), re-encode the
  generated x' and maximise ``log q(c' | x')``.  One mvndiag head covers
  ``zdim + code_dim`` units, sliced into (z, c), as in the JAX package."""

  def __init__(self,
               mi_coef: float = 0.2,
               code_dim: int = 10,
               minimize_kl_codes: bool = True,
               latents: Optional[RVconf] = None,
               **kwargs):
    if latents is None:
      latents = RVconf(32, "mvndiag", projection=True, name="latents")
    if latents.posterior != "mvndiag":
      raise ValueError("MIVAE requires an mvndiag latent family")
    self.code_dim = int(code_dim)
    self.main_dim = latents.event_size
    latents = latents.copy(event_shape=(self.main_dim + self.code_dim,))
    self.mi_coef = float(mi_coef)
    self.minimize_kl_codes = bool(minimize_kl_codes)
    super().__init__(latents=latents, **kwargs)
    self._mi_priors: Dict[torch.device, tuple] = {}

  def _priors_on(self, device):
    """(main prior, codes prior) on `device`, standard normals."""
    if device not in self._mi_priors:
      self._mi_priors[device] = tuple(
          MultivariateNormalDiag(torch.zeros(d, device=device),
                                 torch.ones(d, device=device))
          for d in (self.main_dim, self.code_dim))
    return self._mi_priors[device]

  def _slice(self, qz):
    m = self.main_dim
    return (MultivariateNormalDiag(qz.loc[..., :m], qz.scale_diag[..., :m]),
            MultivariateNormalDiag(qz.loc[..., m:], qz.scale_diag[..., m:]))

  def elbo_components(self, params, batch, rng, step, training=False,
                      mutables=None):
    x, y = self._split_inputs(batch)
    noise = as_noise(rng)
    qz = self._apply(params, "encode", x, training, mutables, noise)
    qm, qc = self._slice(qz)
    main_prior, codes_prior = self._priors_on(qz.loc.device)
    zm = qm.sample_from(noise)
    c = qc.sample_from(noise)
    zc = torch.cat([zm, c], dim=-1)
    px = self._apply(params, "decode", zc, training, mutables, noise)
    llk = {"llk_image": px.log_prob(x)}
    beta = self._schedule(self.beta, step)
    kl = {"kl_latents": beta * kl_divergence(
        qm, main_prior, analytic=self.analytic, q_sample=zm,
        reverse=self.reverse, free_bits=self.free_bits)}
    if self.minimize_kl_codes:
      kl["kl_codes"] = kl_divergence(qc, codes_prior, analytic=self.analytic,
                                     q_sample=c, reverse=self.reverse)
    # the MI lower bound: recover the codes of generated samples
    n = zm.shape[0]
    z_prime = main_prior.sample_from(noise, (n,))
    c_prime = codes_prior.sample_from(noise, (n,))
    px_prime = self._apply(params, "decode",
                           torch.cat([z_prime, c_prime], dim=-1), training,
                           mutables, noise)
    qz_prime = self._apply(params, "encode", px_prime.mean(), training,
                           mutables, noise)
    _, qc_prime = self._slice(qz_prime)
    llk["mi_codes"] = self.mi_coef * qc_prime.log_prob(c_prime)
    return llk, kl, dict(qz=qz, px=px, z=zc, x=x, y=y)
