"""Fréchet distances of the port (PyTorch port of ``frechet_distance`` and
``frechet_inception_distance``, ``odin_tpu/backend/metrics.py:174,191``).

The feature means and covariances are computed in float64 on the device
of the features; the matrix square root runs on the host with scipy's
``sqrtm``, as in the JAX package.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

__all__ = ["frechet_distance", "frechet_inception_distance"]


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
  """Fréchet distance between two Gaussians (mean, covariance)."""
  from scipy import linalg
  mu1, mu2 = (np.atleast_1d(np.asarray(m, np.float64)) for m in (mu1, mu2))
  sigma1, sigma2 = (np.atleast_2d(np.asarray(s, np.float64))
                    for s in (sigma1, sigma2))
  diff = mu1 - mu2
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")  # sqrtm warns on ill-conditioned input
    covmean = linalg.sqrtm(sigma1 @ sigma2)
  if not np.isfinite(covmean).all():
    offset = np.eye(sigma1.shape[0]) * eps
    covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
  if np.iscomplexobj(covmean):
    covmean = covmean.real
  return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) -
               2 * np.trace(covmean))


def _moments(features):
  """Mean and covariance (ddof 1, as ``np.cov``) in float64 of (N, ...)
  features flattened to (N, F), on the features' device."""
  f = torch.as_tensor(features)
  f = f.reshape(f.shape[0], -1).to(torch.float64)
  return (f.mean(0).cpu().numpy(),
          torch.atleast_2d(torch.cov(f.T)).cpu().numpy())


def frechet_inception_distance(features1, features2) -> float:
  """FID over two sets of pre-extracted feature activations (arrays or
  tensors, (N, ...)); the caller supplies the network (the Gym uses the
  encoder's mean latents when no inception weights are at hand)."""
  mu1, s1 = _moments(features1)
  mu2, s2 = _moments(features2)
  return frechet_distance(mu1, s1, mu2, s2)
