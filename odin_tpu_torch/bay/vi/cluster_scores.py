"""Clustering scores of the port, on the device of their inputs:
scikit-learn 1.9's ``adjusted_rand_score``, ``adjusted_mutual_info_score``
and ``normalized_mutual_info_score`` (arithmetic normalisation), and
``silhouette_score`` (euclidean), carried in torch (the card's machine has
no scikit-learn).

- ARI: the pair confusion matrix of the contingency table, in integers;
- AMI: the mutual information of ``estimators.mutual_info_matrix`` (one
  ``bincount``, float64), the expected mutual information of
  ``_expected_mutual_info_fast.pyx`` term for term in float64 (``lgamma``;
  every (class, cluster, n_ij) term at once, class by class), and the
  entropies of ``_entropy``;
- silhouette: the distances of scikit-learn's float32 path (squared in
  float64 as ``_euclidean_distances_upcast`` does, rounded to float32, the
  square root in float32), row chunk by row chunk so that 10,000 rows never
  make one n × n float64 matrix; each row's sum over each cluster in
  float64, rounded to float32 as scikit-learn stores it.
"""
from __future__ import annotations

import math

import torch

from odin_tpu_torch.bay.vi.estimators import (as_tensor, device_of,
                                              mutual_info_matrix)
from odin_tpu_torch.ml.neighbors import row_chunks

__all__ = ["adjusted_rand_score", "adjusted_mutual_info_score",
           "normalized_mutual_info_score", "silhouette_score",
           "contingency_matrix"]

EPS = 2.220446049250313e-16  # np.finfo('float64').eps


def _codes(labels_true, labels_pred, device=None):
  dev = device_of(labels_true, labels_pred, device=device)
  a = as_tensor(labels_true, dev).reshape(-1)
  b = as_tensor(labels_pred, dev).reshape(-1)
  if a.shape != b.shape:
    raise ValueError(f"labels_true and labels_pred must have the same "
                     f"length, got {a.numel()} and {b.numel()}")
  _, ia = torch.unique(a, return_inverse=True)
  _, ib = torch.unique(b, return_inverse=True)
  return ia, ib


def contingency_matrix(ia: torch.Tensor, ib: torch.Tensor) -> torch.Tensor:
  """(n_classes, n_clusters) int64 counts of two encoded labellings."""
  r, c = int(ia.max()) + 1, int(ib.max()) + 1
  return torch.bincount(ia * c + ib, minlength=r * c).reshape(r, c)


def adjusted_rand_score(labels_true, labels_pred, device=None) -> float:
  """The Rand index adjusted for chance (Hubert and Arabie)."""
  ia, ib = _codes(labels_true, labels_pred, device)
  table = contingency_matrix(ia, ib)
  n = ia.numel()
  n_c, n_k = table.sum(1), table.sum(0)
  sums = torch.stack([(table * table).sum(), (table * n_k[None]).sum(),
                      (table * n_c[:, None]).sum()]).tolist()
  sum_squares, row_dot, col_dot = (int(v) for v in sums)
  tp = sum_squares - n
  fp = row_dot - sum_squares
  fn = col_dot - sum_squares
  tn = n * n - fp - fn - sum_squares
  if fn == 0 and fp == 0:
    return 1.0
  return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) +
                                      (tp + fp) * (fp + tn))


def _entropy(codes: torch.Tensor) -> float:
  pi = torch.bincount(codes).to(torch.float64)
  pi = pi[pi > 0]
  if pi.numel() == 1:
    return 0.0
  total = pi.sum()
  return float(-torch.sum((pi / total) * (torch.log(pi) - torch.log(total))))


def expected_mutual_information(table: torch.Tensor, n: int) -> float:
  """The expected mutual information of two labellings with these
  marginals under the hypergeometric model (Vinh et al.), in nats."""
  a = table.sum(1)
  b = table.sum(0)
  if a.numel() == 1 or b.numel() == 1:
    return 0.0
  dev = table.device
  f64 = torch.float64
  top = int(max(int(a.max()), int(b.max())))
  nijs = torch.arange(top + 1, dtype=f64, device=dev)
  nijs[0] = 1.0
  term1 = nijs / n
  log_nnij = math.log(n) + torch.log(nijs)
  gln_nnij = torch.lgamma(nijs + 1) + math.lgamma(n + 1)
  a64, b64 = a.to(f64), b.to(f64)
  log_a, log_b = torch.log(a64), torch.log(b64)
  gln_a, gln_b = torch.lgamma(a64 + 1), torch.lgamma(b64 + 1)
  gln_na, gln_nb = torch.lgamma(n - a64 + 1), torch.lgamma(n - b64 + 1)
  span = int(torch.minimum(a[:, None], b[None]).max())
  k = torch.arange(1, span + 1, device=dev)  # the n_ij of each term
  emi = torch.zeros((), dtype=f64, device=dev)
  for rows in row_chunks(a.numel(), b.numel() * span, 8):
    ai, ai64 = a[rows, None, None], a64[rows, None, None]
    bj, bj64 = b[None, :, None], b64[None, :, None]
    start = torch.clamp(ai - n + bj, min=1)
    end = torch.minimum(ai, bj) + 1
    valid = (k >= start) & (k < end)
    kk = torch.where(valid, k, torch.ones_like(k))
    k64 = kk.to(f64)
    term2 = log_nnij[kk] - log_a[rows, None, None] - log_b[None, :, None]
    gln = (gln_a[rows, None, None] + gln_b[None, :, None] +
           gln_na[rows, None, None] + gln_nb[None, :, None] - gln_nnij[kk] -
           torch.lgamma(torch.where(valid, ai64 - k64 + 1, 1.0)) -
           torch.lgamma(torch.where(valid, bj64 - k64 + 1, 1.0)) -
           torch.lgamma(torch.where(valid, n - ai64 - bj64 + k64 + 1, 1.0)))
    terms = term1[kk] * term2 * torch.exp(gln)
    emi = emi + torch.where(valid, terms, torch.zeros_like(terms)).sum()
  return float(emi)


def adjusted_mutual_info_score(labels_true, labels_pred,
                               average_method: str = "arithmetic",
                               device=None) -> float:
  """The mutual information adjusted for chance, normalised by the
  arithmetic mean of the two entropies."""
  if average_method != "arithmetic":
    raise ValueError("only average_method='arithmetic' is ported")
  ia, ib = _codes(labels_true, labels_pred, device)
  n_classes, n_clusters = int(ia.max()) + 1, int(ib.max()) + 1
  if n_classes == n_clusters == 1:
    return 1.0
  if n_classes == 1 or n_clusters == 1:
    return 0.0
  mi = float(mutual_info_matrix(ia[:, None], ib[:, None])[0, 0])
  emi = expected_mutual_information(contingency_matrix(ia, ib), ia.numel())
  normalizer = (_entropy(ia) + _entropy(ib)) / 2
  denominator = normalizer - emi
  denominator = min(denominator, -EPS) if denominator < 0 else max(
      denominator, EPS)
  numerator = mi - emi
  numerator = min(numerator, -EPS) if numerator < 0 else max(numerator, EPS)
  return float(numerator / denominator)


def normalized_mutual_info_score(labels_true, labels_pred,
                                 average_method: str = "arithmetic",
                                 device=None) -> float:
  """The mutual information over the arithmetic mean of the two
  entropies."""
  if average_method != "arithmetic":
    raise ValueError("only average_method='arithmetic' is ported")
  ia, ib = _codes(labels_true, labels_pred, device)
  if int(ia.max()) == int(ib.max()) == 0:
    return 1.0
  mi = float(mutual_info_matrix(ia[:, None], ib[:, None])[0, 0])
  if mi == 0:
    return 0.0
  return float(mi / ((_entropy(ia) + _entropy(ib)) / 2))


def silhouette_score(X, labels, device=None) -> float:
  """The mean silhouette coefficient of the rows of X under `labels`
  (euclidean); raises ValueError unless 2 <= n_labels <= n - 1."""
  dev = device_of(X, labels, device=device)
  X = as_tensor(X, dev)
  if not X.is_floating_point():
    X = X.to(torch.float64)
  _, codes = torch.unique(as_tensor(labels, dev).reshape(-1),
                          return_inverse=True)
  n = X.shape[0]
  n_labels = int(codes.max()) + 1
  if not 1 < n_labels < n:
    raise ValueError(f"Number of labels is {n_labels}. Valid values are 2 "
                     f"to n_samples - 1 (inclusive)")
  freqs = torch.bincount(codes, minlength=n_labels)
  onehot = torch.nn.functional.one_hot(codes, n_labels).to(torch.float64)
  X64 = X.to(torch.float64)
  x_sq = (X64 * X64).sum(1)
  intra, inter = [], []
  for rows in row_chunks(n, n, 3):
    d2 = (-2.0 * (X64[rows] @ X64.T) + x_sq[rows, None]) + x_sq[None]
    d = torch.sqrt(torch.clamp(d2.to(X.dtype), min=0.0))
    r = torch.arange(rows.start, rows.stop, device=dev)
    d[r - rows.start, r] = 0.0
    cluster = (d.to(torch.float64) @ onehot).to(X.dtype)
    own = codes[rows]
    intra_rows = cluster.gather(1, own[:, None])[:, 0]
    cluster.scatter_(1, own[:, None], math.inf)
    inter.append((cluster / freqs.to(X.dtype)).min(1).values)
    intra.append(intra_rows)
  intra = torch.cat(intra) / (freqs[codes] - 1).to(X.dtype)
  inter = torch.cat(inter)
  sil = (inter - intra) / torch.maximum(intra, inter)
  return float(torch.nan_to_num(sil).to(torch.float64).mean())
