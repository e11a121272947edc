"""Objectives (PyTorch port of ``odin_tpu/bay/vi/losses.py``; the
total-correlation estimator so far)."""
from __future__ import annotations

import math

import torch

from odin_tpu_torch.bay.distributions import Distribution

__all__ = ["total_correlation"]


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
