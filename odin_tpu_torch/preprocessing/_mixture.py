"""scikit-learn 1.9's diagonal ``GaussianMixture`` and its k-means seeding,
carried in NumPy for the speech front-end (the card's machine has no
scikit-learn, and the extractors run in forked workers, where no torch op
may run).

``GaussianMixture`` follows ``sklearn/mixture/_gaussian_mixture.py`` with
``covariance_type='diag'`` expression for expression, in the data's dtype:
the parameters from ``weights_init``/``means_init``/``precisions_init``
when all three are given (no k-means then), else from the labels of
``KMeans(n_clusters, n_init=1, random_state)``; EM to ``max_iter`` with the
``tol`` stop on the mean log-likelihood; a covariance at or below zero, too
few or non-finite samples raise ``ValueError`` as scikit-learn's do.

``KMeans`` is scikit-learn's Lloyd from greedy k-means++ on the data
centred on its mean (``2 + int(log k)`` trials a centre, the seeding
distances in float64 rounded to the data's dtype, as its
``_euclidean_distances`` makes them), with the strict and the ``tol``
stops, empty clusters relocated to the farthest rows and a last E-step.
Its E-step is ``|c|² − 2x·cᵀ`` in the data's dtype; the members' sums are
made in float64 and rounded (scikit-learn sums them in the data's dtype in
an order its threads decide).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

__all__ = ["GaussianMixture", "KMeans"]


def _logsumexp(a: np.ndarray, axis: int) -> np.ndarray:
  """scikit-learn's ``utils._array_api._logsumexp`` (numpy)."""
  a_max = np.max(a, axis=axis, keepdims=True)
  index_max = a == a_max
  a = np.array(a, copy=True)
  a[index_max] = -np.inf
  m = np.sum(index_max.astype(a.dtype), axis=axis, keepdims=True,
             dtype=a.dtype)
  shift = np.where(np.isfinite(a_max), a_max, 0)
  e = np.exp(a - shift)
  s = np.sum(e, axis=axis, keepdims=True, dtype=e.dtype)
  s = np.where(s == 0, s, s / m)
  out = np.log1p(s) + np.log(m) + a_max
  return np.squeeze(out, axis=axis)


def _validate(X) -> np.ndarray:
  X = np.asarray(X)
  if X.dtype not in (np.float32, np.float64):
    X = X.astype(np.float64)
  if X.ndim != 2:
    raise ValueError(f"Expected 2D array, got {X.ndim}D array instead")
  if X.shape[0] < 2:
    raise ValueError(f"Found array with {X.shape[0]} sample(s) while a "
                     "minimum of 2 is required.")
  if not np.isfinite(X).all():
    raise ValueError("Input contains NaN or infinity.")
  return X


class KMeans:
  """``sklearn.cluster.KMeans(n_clusters, n_init=1, random_state)`` with
  dense unweighted data (see the module docstring)."""

  def __init__(self, n_clusters: int = 8, max_iter: int = 300,
               tol: float = 1e-4, random_state=None):
    self.n_clusters = int(n_clusters)
    self.max_iter = int(max_iter)
    self.tol = float(tol)
    self.random_state = random_state

  @staticmethod
  def _sq_dist(rows: np.ndarray, X: np.ndarray, x_sq: np.ndarray
               ) -> np.ndarray:
    """scikit-learn's float64 ``_euclidean_distances`` from `rows` to X,
    clipped at 0 and in X's dtype."""
    if X.dtype == np.float32:
      r = rows.astype(np.float64)
      x = X.astype(np.float64)
      d = -2 * (r @ x.T)
      d += np.einsum("ij,ij->i", r, r)[:, None]
      d += np.einsum("ij,ij->i", x, x)[None, :]
      d = d.astype(np.float32)
    else:
      d = -2 * (rows @ X.T)
      d += np.einsum("ij,ij->i", rows, rows)[:, None]
      d += x_sq[None, :]
    return np.maximum(d, 0)

  def _kmeans_plusplus(self, X, x_sq, rng) -> np.ndarray:
    n = X.shape[0]
    k = self.n_clusters
    weight = np.ones(n, dtype=X.dtype)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, X.shape[1]), dtype=X.dtype)
    center_id = rng.choice(n, p=weight / weight.sum())
    centers[0] = X[center_id]
    closest = self._sq_dist(centers[0, None], X, x_sq)
    pot = closest @ weight
    for c in range(1, k):
      rand_vals = rng.uniform(size=trials) * pot
      cand = np.searchsorted(np.cumsum(weight * closest), rand_vals)
      np.clip(cand, None, closest.size - 1, out=cand)
      dist = self._sq_dist(X[cand], X, x_sq)
      np.minimum(closest, dist, out=dist)
      pots = dist @ weight.reshape(-1, 1)
      best = np.argmin(pots)
      pot = pots[best]
      closest = dist[best]
      centers[c] = X[cand[best]]
    return centers

  @staticmethod
  def _labels(X, centers) -> np.ndarray:
    c_sq = np.einsum("ij,ij->i", centers, centers)
    return np.argmin(c_sq[None, :] - 2 * (X @ centers.T), axis=1)

  def fit(self, X) -> "KMeans":
    X = np.array(_validate(X), copy=True)
    n, k = X.shape[0], self.n_clusters
    if n < k:
      raise ValueError(f"n_samples={n} should be >= n_clusters={k}.")
    rng = self.random_state if isinstance(
        self.random_state, np.random.RandomState) else \
        np.random.RandomState(self.random_state)
    tol = np.mean(np.var(X, axis=0)) * self.tol if self.tol else 0
    X_mean = X.mean(axis=0)
    X -= X_mean
    x_sq = np.einsum("ij,ij->i", X, X)
    centers = self._kmeans_plusplus(X, x_sq, rng)
    X64 = X.astype(np.float64)
    labels_old = np.full(n, -1)
    strict = False
    for _ in range(self.max_iter):
      labels = self._labels(X, centers)
      weight = np.bincount(labels, minlength=k).astype(X.dtype)
      sums = np.zeros((k, X.shape[1]))
      np.add.at(sums, labels, X64)
      sums = sums.astype(X.dtype)
      sums, weight = self._relocate_empty(X, centers, sums, weight, labels)
      new = self._average(sums, weight)
      shift = np.sqrt(((new.astype(np.float64) -
                        centers.astype(np.float64)) ** 2).sum(1)).astype(
                            X.dtype)
      centers = new
      if np.array_equal(labels, labels_old):
        strict = True
        break
      if (shift ** 2).sum() <= tol:
        break
      labels_old = labels
    if not strict:
      labels = self._labels(X, centers)
    self.labels_ = labels
    self.cluster_centers_ = centers + X_mean
    return self

  @staticmethod
  def _relocate_empty(X, centers_old, sums, weight, labels):
    """scikit-learn's ``_relocate_empty_clusters_dense``."""
    empty = np.nonzero(weight == 0)[0]
    if len(empty) == 0:
      return sums, weight
    far = ((X - centers_old[labels]) ** 2).sum(1)
    if far.max() == 0:
      return sums, weight
    rows = np.argpartition(far, -len(empty))[:-len(empty) - 1:-1]
    sums, weight = sums.copy(), weight.copy()
    for new_id, row in zip(empty, rows):
      old_id = labels[row]
      sums[old_id] -= X[row]
      sums[new_id] = X[row]
      weight[new_id] = 1
      weight[old_id] -= 1
    return sums, weight

  @staticmethod
  def _average(sums, weight):
    """scikit-learn's ``_average_centers``."""
    out = sums * (1 / np.where(weight > 0, weight, 1))[:, None]
    if (weight == 0).any():
      heavy = int(np.argmax(weight))
      for j in np.nonzero(weight == 0)[0]:
        out[j] = out[heavy] if heavy < j else sums[heavy]
    return out


class GaussianMixture:
  """``sklearn.mixture.GaussianMixture(covariance_type='diag',
  init_params='kmeans', n_init=1)`` (see the module docstring)."""

  def __init__(self, n_components: int = 1, tol: float = 1e-3,
               reg_covar: float = 1e-6, max_iter: int = 100,
               weights_init: Optional[np.ndarray] = None,
               means_init: Optional[np.ndarray] = None,
               precisions_init: Optional[np.ndarray] = None,
               random_state=None):
    self.n_components = int(n_components)
    self.tol = float(tol)
    self.reg_covar = float(reg_covar)
    self.max_iter = int(max_iter)
    self.weights_init = weights_init
    self.means_init = means_init
    self.precisions_init = precisions_init
    self.random_state = random_state

  def _parameters(self, X, resp):
    nk = resp.sum(axis=0) + 10 * np.finfo(resp.dtype).eps
    means = (resp.T @ X) / nk[:, np.newaxis]
    avg_X2 = (resp.T @ (X * X)) / nk[:, np.newaxis]
    return nk, means, avg_X2 - means ** 2 + self.reg_covar

  def _precision_cholesky(self, covariances):
    if np.any(covariances <= 0.0):
      raise ValueError("Fitting the mixture model failed because some "
                       "components have ill-defined empirical covariance.")
    return 1.0 / np.sqrt(covariances)

  def _check_inits(self, n_features: int):
    k = self.n_components
    if self.weights_init is not None:
      w = np.asarray(self.weights_init, np.float64)
      if w.shape != (k,) or (w < 0).any() or (w > 1).any() or \
          not np.allclose(abs(1.0 - w.sum()), 0.0, atol=1e-8):
        raise ValueError("weights_init must be (n_components,) in [0, 1], "
                         "summing to 1")
      self.weights_init = w
    if self.means_init is not None:
      m = np.asarray(self.means_init, np.float64)
      if m.shape != (k, n_features):
        raise ValueError(f"means_init must be {(k, n_features)}")
      self.means_init = m
    if self.precisions_init is not None:
      p = np.asarray(self.precisions_init, np.float64)
      if p.shape != (k, n_features) or (p <= 0).any():
        raise ValueError("precisions_init must be positive, "
                         f"{(k, n_features)}")
      self.precisions_init = p

  def _initialize(self, X):
    if self.weights_init is not None and self.means_init is not None and \
        self.precisions_init is not None:
      self.weights_ = self.weights_init
      self.means_ = self.means_init
      self.precisions_cholesky_ = np.sqrt(self.precisions_init)
      return
    n = X.shape[0]
    resp = np.zeros((n, self.n_components), dtype=X.dtype)
    label = KMeans(self.n_components, random_state=self._rng).fit(X).labels_
    resp[np.arange(n), label] = 1
    weights, means, covariances = self._parameters(X, resp)
    if self.weights_init is None:
      weights /= n
    self.weights_ = weights if self.weights_init is None else \
        self.weights_init
    self.means_ = means if self.means_init is None else self.means_init
    if self.precisions_init is None:
      self.covariances_ = covariances
      self.precisions_cholesky_ = self._precision_cholesky(covariances)
    else:
      self.precisions_cholesky_ = np.sqrt(self.precisions_init)

  def _log_prob_resp(self, X):
    n_features = X.shape[1]
    prec = self.precisions_cholesky_ ** 2
    log_det = np.sum(np.log(self.precisions_cholesky_), axis=1)
    log_prob = (np.sum(self.means_ ** 2 * prec, axis=1)
                - 2.0 * (X @ (self.means_ * prec).T) + (X ** 2 @ prec.T))
    weighted = (-0.5 * (n_features * math.log(2 * math.pi) + log_prob)
                + log_det + np.log(self.weights_))
    norm = _logsumexp(weighted, axis=1)
    with np.errstate(under="ignore"):
      log_resp = weighted - norm[:, np.newaxis]
    return norm, log_resp

  def fit(self, X) -> "GaussianMixture":
    X = _validate(X)
    if X.shape[0] < self.n_components:
      raise ValueError("Expected n_samples >= n_components but got "
                       f"n_components = {self.n_components}, "
                       f"n_samples = {X.shape[0]}")
    self._check_inits(X.shape[1])
    self._rng = self.random_state if isinstance(
        self.random_state, np.random.RandomState) else \
        np.random.RandomState(self.random_state)
    self._initialize(X)
    lower = -np.inf
    self.converged_ = False
    for n_iter in range(1, self.max_iter + 1):
      previous = lower
      norm, log_resp = self._log_prob_resp(X)
      lower = np.mean(norm)
      nk, self.means_, self.covariances_ = self._parameters(
          X, np.exp(log_resp))
      self.weights_ = nk / np.sum(nk)
      self.precisions_cholesky_ = self._precision_cholesky(
          self.covariances_)
      if abs(lower - previous) < self.tol:
        self.converged_ = True
        break
    self.n_iter_ = n_iter
    self.lower_bound_ = lower
    self.precisions_ = self.precisions_cholesky_ ** 2
    return self

  def predict_proba(self, X) -> np.ndarray:
    return np.exp(self._log_prob_resp(np.asarray(X))[1])

  def predict(self, X) -> np.ndarray:
    return np.argmax(self._log_prob_resp(np.asarray(X))[1], axis=1)
