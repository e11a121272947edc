"""Nearest neighbours of the port, on the device of their inputs:
scikit-learn 1.9's ``NearestNeighbors`` and ``KNeighborsClassifier`` (uniform
weights), carried in torch (the card's machine has no scikit-learn).

Distances follow the method scikit-learn's ``algorithm='auto'`` picks for
the features these callers give (at most 15): its KD-tree, whose squared
distance is summed feature by feature in float64, ``Σ_k (a_k − b_k)²``; or,
where ``n_neighbors >= n_samples // 2``, its brute-force search, whose
squared distance is ``|a|² + (−2·a·bᵀ) + |b|²`` in float64.  The distance is
the square root.  The rows of a query are taken in chunks, so that no block
of distances outgrows ``CHUNK_ELEMENTS``.  Ties between equal distances go
to the lower index.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from odin_tpu_torch.device import as_tensor, device_of

__all__ = ["CHUNK_ELEMENTS", "row_chunks", "sq_distances", "sqrt_rn",
           "brute_sq_distances", "kneighbors",
           "NearestNeighbors", "KNeighborsClassifier"]

# elements of one chunk's (rows, n) block of float64 distances: 256 MiB
CHUNK_ELEMENTS = 1 << 25


def row_chunks(n_rows: int, n_cols: int, per_element: int = 1
               ) -> Iterator[slice]:
  """Slices of the query rows so that a (rows, n_cols) block, each element
  taking `per_element` blocks' worth of memory, stays in
  ``CHUNK_ELEMENTS``."""
  step = max(1, CHUNK_ELEMENTS // max(1, n_cols * per_element))
  for start in range(0, n_rows, step):
    yield slice(start, min(n_rows, start + step))


def sq_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """(len(a), len(b)) float64 squared distances, summed feature by feature
  in order, as scikit-learn's trees sum them."""
  a = a.to(torch.float64)
  b = b.to(torch.float64)
  out = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float64,
                    device=a.device)
  for k in range(a.shape[1]):
    diff = a[:, k, None] - b[None, :, k]
    out += diff * diff
  return out


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
  """The float64 square root rounded to nearest, as numpy's and CUDA's
  are: PyTorch's CPU kernel can be one ulp off, so a CPU tensor takes
  numpy's (the CPU stands in for the card in tests, where a distance is
  compared with a radius)."""
  if x.device.type == "cpu" and x.dtype == torch.float64:
    return torch.from_numpy(np.sqrt(x.numpy()))
  return torch.sqrt(x)


def brute_sq_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """(len(a), len(b)) float64 squared distances as scikit-learn's
  brute-force search forms them: ``(|a|² + (−2·a·bᵀ)) + |b|²``."""
  a = a.to(torch.float64)
  b = b.to(torch.float64)
  return ((a * a).sum(1)[:, None] + (-2.0 * (a @ b.T))) + (b * b).sum(1)[None]


def kneighbors(queries: torch.Tensor, points: torch.Tensor, k: int,
               exclude_self: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(distances (q, k) float64, indices (q, k) int64) of each query's `k`
  nearest points, nearest first.  With `exclude_self` the queries are the
  points and each row leaves out the point itself once (scikit-learn's
  ``kneighbors()`` with no query)."""
  n = points.shape[0]
  take = k + int(exclude_self)
  if take > n:
    raise ValueError(f"Expected n_neighbors <= n_samples_fit, but "
                     f"n_neighbors = {take}, n_samples_fit = {n}")
  distances = brute_sq_distances if k >= n // 2 else sq_distances
  dists, idxs = [], []
  for rows in row_chunks(queries.shape[0], n):
    d2 = distances(queries[rows], points)
    if exclude_self:
      r = torch.arange(rows.start, rows.stop, device=d2.device)
      d2[r - rows.start, r] = -1.0
    # the lower index first among equal distances: order by (d², index)
    vals, idx = torch.sort(d2, dim=1, stable=True)
    vals, idx = vals[:, :take], idx[:, :take]
    if exclude_self:
      vals, idx = vals[:, 1:], idx[:, 1:]
    dists.append(sqrt_rn(torch.clamp(vals, min=0.0)))
    idxs.append(idx)
  return torch.cat(dists), torch.cat(idxs)


class NearestNeighbors:
  """scikit-learn's ``NearestNeighbors(n_neighbors)`` with the euclidean
  metric: ``kneighbors`` (no query: each point's neighbours but itself)."""

  def __init__(self, n_neighbors: int = 5, device=None, **kwargs):
    unknown = set(kwargs) - {"algorithm", "leaf_size", "n_jobs", "p",
                             "metric"}
    if unknown or kwargs.get("metric", "euclidean") not in (
        "euclidean", "minkowski") or kwargs.get("p", 2) != 2:
      raise ValueError(f"only the euclidean metric is ported, got {kwargs}")
    self.n_neighbors = int(n_neighbors)
    self.device = device

  def fit(self, X, y=None) -> "NearestNeighbors":
    self._fit_X = as_tensor(X, device_of(X, device=self.device))
    self.n_samples_fit_ = self._fit_X.shape[0]
    self.n_features_in_ = self._fit_X.shape[1]
    return self

  def kneighbors(self, X=None, n_neighbors: Optional[int] = None,
                 return_distance: bool = True):
    k = self.n_neighbors if n_neighbors is None else int(n_neighbors)
    if X is None:
      d, i = kneighbors(self._fit_X, self._fit_X, k, exclude_self=True)
    else:
      d, i = kneighbors(as_tensor(X, self._fit_X.device), self._fit_X, k)
    return (d, i) if return_distance else i


class KNeighborsClassifier(NearestNeighbors):
  """scikit-learn's ``KNeighborsClassifier(n_neighbors)`` with uniform
  weights: the most frequent class among the neighbours, the smallest class
  among equally frequent ones."""

  def fit(self, X, y) -> "KNeighborsClassifier":
    super().fit(X)
    y = as_tensor(y, self._fit_X.device).reshape(-1)
    self.classes_, self._y = torch.unique(y, return_inverse=True)
    return self

  def predict_proba(self, X=None) -> torch.Tensor:
    idx = self.kneighbors(X, return_distance=False)
    votes = torch.nn.functional.one_hot(self._y[idx],
                                        self.classes_.numel()).sum(1)
    return votes.to(torch.float64) / idx.shape[1]

  def predict(self, X=None) -> torch.Tensor:
    # argmax takes the first of equal counts: the smallest class
    return self.classes_[torch.argmax(self.predict_proba(X), dim=1)]

  def score(self, X, y) -> float:
    y = as_tensor(y, self._fit_X.device).reshape(-1)
    return float((self.predict(X) == y).to(torch.float64).mean())
