"""Objectives (PyTorch port of ``odin_tpu/bay/vi/losses.py``): the
total-correlation estimator, the DIP covariance penalty, the kernels and
the maximum mean discrepancy, and ``get_divergence``."""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from odin_tpu_torch.bay.distributions import Distribution

__all__ = [
    "total_correlation", "disentangled_inferred_prior_loss",
    "pairwise_distances", "gaussian_kernel", "linear_kernel",
    "polynomial_kernel", "maximum_mean_discrepancy", "get_divergence",
]


def get_divergence(name: str):
  """'dip', 'tc', 'mmd' or 'kl' -> the divergence's function."""
  from odin_tpu_torch.bay.helpers import kl_divergence
  div = dict(dip=disentangled_inferred_prior_loss,
             tc=total_correlation,
             mmd=maximum_mean_discrepancy,
             kl=kl_divergence)
  key = str(name).strip().lower()
  if key not in div:
    raise ValueError(f"Cannot find divergence with name: '{name}', "
                     f"all available are: {', '.join(div)}")
  return div[key]


def total_correlation(z_samples: torch.Tensor,
                      qz_x: Distribution) -> torch.Tensor:
  """Minibatch-weighted TC estimator (Chen et al. 2019, Eq. 4 with
  alpha = gamma = 1): ``E_j[log q(z_j) - log prod_l q(z_j_l)]`` from the
  pairwise posterior log-probs (O(n^2 d)), without the constant terms."""
  mean = qz_x.mean()
  std = qz_x.stddev()
  # log q(z(x_j) | x_i): (j, i, l)
  z = z_samples[:, None, :]
  lp = -0.5 * (((z - mean[None]) / std[None]) ** 2) - torch.log(std[None]) \
      - 0.5 * math.log(2.0 * math.pi)
  log_qz_product = torch.sum(torch.logsumexp(lp, dim=1), dim=1)
  log_qz = torch.logsumexp(torch.sum(lp, dim=2), dim=1)
  return torch.mean(log_qz - log_qz_product)


def disentangled_inferred_prior_loss(qz_x: Distribution,
                                     only_mean: bool = False,
                                     lambda_offdiag: float = 2.0,
                                     lambda_diag: float = 1.0
                                     ) -> torch.Tensor:
  """DIP covariance penalty (Kumar et al. 2018): the aggregate posterior's
  covariance held to the identity, Cov[E(z)] for type 'i' (`only_mean`),
  E[Cov(z)] + Cov[E(z)] for type 'ii'."""
  z_mean = qz_x.mean()
  z_mean = z_mean.reshape(-1, z_mean.shape[-1])
  e_zz = torch.mean(z_mean[:, :, None] * z_mean[:, None, :], dim=0)
  e_z = torch.mean(z_mean, dim=0)
  cov_zmean = e_zz - e_z[:, None] * e_z[None, :]
  if only_mean:
    z_cov = cov_zmean
  else:
    z_var = qz_x.variance().reshape(-1, z_mean.shape[-1])
    z_cov = cov_zmean + torch.diag(torch.mean(z_var, dim=0))
  diag = torch.diagonal(z_cov)
  offdiag = z_cov - torch.diag(diag)
  return (lambda_offdiag * torch.sum(offdiag ** 2) +
          lambda_diag * torch.sum((diag - 1.0) ** 2))


def pairwise_distances(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  """(n, d), (m, d) -> the (n, m, d) differences."""
  x = x.reshape(-1, x.shape[-1])
  y = y.reshape(-1, y.shape[-1])
  return x[:, None, :] - y[None, :, :]


def gaussian_kernel(x: torch.Tensor, y: torch.Tensor,
                    sigma: Optional[float] = None) -> torch.Tensor:
  d = pairwise_distances(x, y)
  gamma = (1.0 / x.shape[-1]) if sigma is None else 1.0 / (2.0 * sigma ** 2)
  return torch.exp(-torch.sum(d * d, dim=-1) * gamma)


def linear_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  return torch.abs(torch.sum(pairwise_distances(x, y), dim=-1))


def polynomial_kernel(x: torch.Tensor, y: torch.Tensor, degree: int = 2,
                      gamma: Optional[float] = None,
                      coef0: float = 1.0) -> torch.Tensor:
  """``K(x, y) = (gamma <x, y> + coef0)^degree``, gamma 1/d by default."""
  x = x.reshape(-1, x.shape[-1])
  y = y.reshape(-1, y.shape[-1])
  if gamma is None:
    gamma = 1.0 / x.shape[-1]
  return (gamma * (x @ y.T) + coef0) ** degree


def maximum_mean_discrepancy(qz: Distribution,
                             pz: Distribution,
                             noise,
                             q_sample_shape: Union[int, None] = (),
                             p_sample_shape: int = 100,
                             kernel: str = "gaussian",
                             q_samples: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
  """``MMD^2(q, p) = E[K(x, x')] + E[K(y, y')] - 2 E[K(x, y)]``, x from q
  (or `q_samples`), y `p_sample_shape` draws from p; the draws come from
  `noise` (a ``training.core.Noise``), q's first, as the JAX package
  splits its key."""
  if q_samples is not None:
    x = q_samples
  elif q_sample_shape == () or q_sample_shape is None:
    x = qz.sample_from(noise)
  else:
    x = qz.sample_from(noise, (int(q_sample_shape),))
  y = pz.sample_from(noise, (int(p_sample_shape),))
  x = x.reshape(-1, x.shape[-1])
  y = y.reshape(-1, y.shape[-1])
  kern = {"gaussian": gaussian_kernel, "linear": linear_kernel,
          "polynomial": polynomial_kernel}[kernel]
  return (torch.mean(kern(x, x)) + torch.mean(kern(y, y)) -
          2.0 * torch.mean(kern(x, y)))
