"""Disentanglement metrics of the port (PyTorch port of
``odin_tpu/bay/vi/metrics.py``): ``Correlation``, the discrete mutual
information and entropy, the k-NN estimate ``mutual_info_estimate``, MIG,
``correlation_matrix`` ('spearman', 'pearson', 'lasso', 'mutualinfo',
'importance'), ``relative_strength`` and ``unsupervised_clustering_scores``
(KMeans, ARI, AMI, NMI, silhouette).

Every function takes arrays or tensors and runs on the device of its first
tensor argument, or on `device` (the card for arrays unless asked for the
CPU).  The scikit-learn estimators they fit are carried in torch
(``correlation_estimators``, ``cluster_scores``, ``ml.cluster``).
"""
from __future__ import annotations

from enum import IntFlag, auto

import torch

from odin_tpu_torch.bay.vi import cluster_scores as _cs
from odin_tpu_torch.bay.vi.correlation_estimators import (
    Lasso, mutual_info_classif, mutual_info_regression)
from odin_tpu_torch.bay.vi.estimators import (as_tensor, device_of,
                                              mutual_info_matrix)
from odin_tpu_torch.ml.cluster import KMeans

__all__ = [
    "Correlation", "discrete_mutual_info", "discrete_entropy",
    "mutual_info_estimate", "mutual_info_gap", "correlation_matrix",
    "relative_strength", "unsupervised_clustering_scores",
]


class Correlation(IntFlag):
  """Correlation estimator flags."""

  Pearson = auto()
  Spearman = auto()
  Lasso = auto()
  MutualInfo = auto()
  Importance = auto()


def discrete_mutual_info(codes, factors, device=None) -> torch.Tensor:
  """[n_codes, n_factors] of scikit-learn's ``mutual_info_score(factors[:,
  j], codes[:, i])`` (float64, in nats)."""
  dev = device_of(codes, factors, device=device)
  codes = torch.atleast_2d(as_tensor(codes, dev))
  factors = torch.atleast_2d(as_tensor(factors, dev))
  return mutual_info_matrix(factors, codes).T


def discrete_entropy(labels, device=None) -> torch.Tensor:
  """Entropy (nats, float64) of a label vector, or of each column of a
  label matrix."""
  labels = as_tensor(labels, device_of(labels, device=device))

  def h(col):
    _, counts = torch.unique(col, return_counts=True)
    p = counts.to(torch.float64) / counts.sum()
    return -torch.sum(p * torch.log(p))

  if labels.ndim <= 1:
    return h(labels.reshape(-1))
  return torch.stack([h(labels[:, j]) for j in range(labels.shape[1])])


def mutual_info_estimate(representations, factors,
                         continuous_latents: bool = True,
                         continuous_factors: bool = False,
                         n_neighbors: int = 3, seed: int = 1,
                         device=None) -> torch.Tensor:
  """[n_latents, n_factors] k-NN mutual information (nats, float64):
  scikit-learn's ``mutual_info_classif`` of each factor (or
  ``mutual_info_regression`` for continuous factors), the latents
  continuous unless `continuous_latents` is False, the jitter drawn from a
  ``RandomState(seed)`` for each factor."""
  dev = device_of(representations, factors, device=device)
  z = as_tensor(representations, dev)
  f = torch.atleast_2d(as_tensor(factors, dev))
  mi_fn = mutual_info_regression if continuous_factors else \
      mutual_info_classif
  return torch.stack([mi_fn(z, f[:, j], discrete_features=not
                            continuous_latents, n_neighbors=n_neighbors,
                            random_state=seed)
                      for j in range(f.shape[1])], 1)


def mutual_info_gap(representations, factors, device=None) -> float:
  """MIG (Chen et al. 2018): the mean over factors of the gap between the
  two largest mutual informations with a latent, over the factor's
  entropy.  Inputs must be discretized."""
  dev = device_of(representations, factors, device=device)
  codes = torch.atleast_2d(as_tensor(representations, dev)).to(torch.int64)
  factors = torch.atleast_2d(as_tensor(factors, dev)).to(torch.int64)
  m = discrete_mutual_info(codes, factors)
  top = torch.sort(m, dim=0, descending=True).values
  h = discrete_entropy(factors)
  return float(torch.mean((top[0] - top[1]) / torch.clamp(h, min=1e-12)))


def _pearson(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  """[x_dim, y_dim] Pearson correlations in float64 (NaN where a column
  is constant, as scipy gives)."""
  x = x - x.mean(0)
  y = y - y.mean(0)
  x = x / torch.linalg.vector_norm(x, dim=0)
  y = y / torch.linalg.vector_norm(y, dim=0)
  return torch.clamp(x.T @ y, -1.0, 1.0)


def _average_ranks(a: torch.Tensor) -> torch.Tensor:
  """Column-wise ranks from 1, ties given their average rank (scipy's
  ``rankdata(method='average')``), float64."""
  out = torch.empty(a.shape, dtype=torch.float64, device=a.device)
  for j in range(a.shape[1]):
    values, inv, counts = torch.unique(a[:, j], return_inverse=True,
                                       return_counts=True)
    ends = torch.cumsum(counts, 0).to(torch.float64)
    out[:, j] = (ends - (counts.to(torch.float64) - 1) / 2)[inv]
  return out


def correlation_matrix(x, y, method: str = "spearman", seed: int = 1,
                       device=None) -> torch.Tensor:
  """[x_dim, y_dim] correlation matrix (float64), NaNs set to 0;
  `method` 'spearman', 'pearson', 'lasso' (the coefficients of
  ``Lasso(alpha=0.05)`` from x to every column of y), 'mutualinfo' (the
  k-NN estimate) or 'importance' (the gradient-boosted trees'
  importances)."""
  dev = device_of(x, y, device=device)
  x = as_tensor(x, dev)
  y = as_tensor(y, dev)
  method = str(method).lower()
  if method == "spearman":
    mat = _pearson(_average_ranks(x), _average_ranks(y))
  elif method == "pearson":
    mat = _pearson(x.to(torch.float64), y.to(torch.float64))
  elif method == "importance":
    from odin_tpu_torch.bay.vi.downstream_metrics import importance_matrix
    mat = importance_matrix(x, y, seed=seed)[0]
  elif method == "lasso":
    coef = Lasso(alpha=0.05, random_state=seed).fit(x, y).coef_
    mat = torch.atleast_2d(coef).T.reshape(x.shape[1], y.shape[1])
  elif method in ("mutualinfo", "mi"):
    mat = mutual_info_estimate(x, y)
  else:
    raise ValueError(f"unknown correlation method '{method}'")
  return torch.nan_to_num(mat)


def relative_strength(mat, device=None) -> float:
  """Mean of max²/sum along both axes of a correlation matrix."""
  mat = torch.abs(as_tensor(mat, device_of(mat, device=device)).to(
      torch.float64))
  sx = torch.nan_to_num(mat.max(0).values ** 2 / mat.sum(0), nan=0.0).mean()
  sy = torch.nan_to_num(mat.max(1).values ** 2 / mat.sum(1), nan=0.0).mean()
  return float((sx + sy) / 2)


def unsupervised_clustering_scores(factors, representations=None,
                                   predictions=None,
                                   algorithm: str = "both",
                                   random_state: int = 1,
                                   device=None) -> dict:
  """ARI, AMI and NMI of a clustering of the representations against one
  factor's labels (scikit-learn's ``KMeans`` with as many clusters as the
  factor has values and ``n_init=4``, unless `predictions` are given), and
  the silhouette of the representations under the factor's labels (0.0
  where it cannot be computed, as in the JAX package)."""
  dev = device_of(factors, representations, predictions, device=device)
  factors = as_tensor(factors, dev).reshape(-1)
  n_clusters = int(torch.unique(factors).numel())
  if predictions is None:
    if representations is None:
      raise ValueError("give the representations or the predictions")
    predictions = KMeans(n_clusters=n_clusters, n_init=4,
                         random_state=random_state).fit_predict(
                             as_tensor(representations, dev))
  predictions = as_tensor(predictions, dev)
  out = dict(ari=_cs.adjusted_rand_score(factors, predictions),
             ami=_cs.adjusted_mutual_info_score(factors, predictions),
             nmi=_cs.normalized_mutual_info_score(factors, predictions))
  if representations is not None and n_clusters > 1:
    try:
      out["asw"] = _cs.silhouette_score(as_tensor(representations, dev),
                                        factors)
    except ValueError:  # fewer than 2 or more than n - 1 labels
      out["asw"] = 0.0
  return out
