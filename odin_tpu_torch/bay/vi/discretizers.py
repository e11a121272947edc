"""The binnings behind ``discretizing``'s 'quantile', 'kmeans' and 'gmm'
strategies, on the device of the column: scikit-learn 1.9's
``KBinsDiscretizer(encode='ordinal')`` and a one-feature
``GaussianMixture``, carried in torch (the card's machine has no
scikit-learn).

- 'quantile': ``np.percentile(column, linspace(0, 100, n_bins + 1),
  method='averaged_inverted_cdf')`` (scikit-learn 1.9's default
  ``quantile_method``) on the sorted column, bins narrower than 1e-8
  removed.  Above ``SUBSAMPLE`` rows scikit-learn first resamples the rows
  with replacement from numpy's global, unseeded ``RandomState``
  (``subsample=200_000, random_state=None``), so the JAX package's result
  there is not deterministic; the port draws the same way, from the same
  generator;
- 'kmeans': ``KMeans`` from the uniform bins' centres, ``n_init=1``, in the
  column's dtype, the edges the midpoints of the sorted centres;
- a row's bin is ``searchsorted(edges[1:-1], x, side='right')``;
- 'gmm': ``GaussianMixture(n_components=n_bins, random_state=1)`` on the
  column (one feature, 'full' covariance): responsibilities from
  ``KMeans(n_init=1)`` on the same ``RandomState``, ``reg_covar`` 1e-6, EM
  until the mean log-likelihood moves by less than ``tol`` 1e-3 or 100
  iterations, a last E-step, each row the most responsible component, in
  the column's dtype as scikit-learn computes.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from odin_tpu_torch.ml.cluster import KMeans

__all__ = ["SUBSAMPLE", "quantile_edges", "kmeans_edges", "bins_of",
           "GaussianMixture"]

SUBSAMPLE = 200_000  # KBinsDiscretizer's default subsample


def _subsampled(col: torch.Tensor) -> torch.Tensor:
  if col.shape[0] <= SUBSAMPLE:
    return col
  rows = np.random.mtrand._rand.randint(0, col.shape[0], size=(SUBSAMPLE,))
  return col[torch.as_tensor(rows, device=col.device)]


def _drop_narrow(edges: torch.Tensor) -> torch.Tensor:
  """Edges whose bin is wider than 1e-8 (the first always kept)."""
  keep = torch.ones_like(edges, dtype=torch.bool)
  keep[1:] = (edges[1:] - edges[:-1]) > 1e-8
  return edges[keep]


def quantile_edges(col: torch.Tensor, n_bins: int) -> torch.Tensor:
  """float64 bin edges at the quantiles of a column (inverted CDF, averaged
  where a quantile falls between two rows)."""
  col = _subsampled(col)
  v = torch.sort(col).values
  n = v.numel()
  q = torch.as_tensor(np.linspace(0, 100, n_bins + 1) / 100, device=col.device)
  virtual = n * q - 1
  prev = torch.floor(virtual)
  gamma = torch.where(virtual - prev == 0, 0.5, 1.0)
  prev_i, next_i = prev.to(torch.int64), prev.to(torch.int64) + 1
  above, below = virtual >= n - 1, virtual < 0
  prev_i = torch.where(above, n - 1, torch.where(below, 0, prev_i))
  next_i = torch.where(above, n - 1, torch.where(below, 0, next_i))
  a, b = v[prev_i], v[next_i]
  diff = (b - a).to(torch.float64)  # b − a in the column's dtype, as numpy
  edges = torch.where(gamma >= 0.5, b.to(torch.float64) - diff * (1 - gamma),
                      a.to(torch.float64) + diff * gamma)
  return _drop_narrow(edges)


def kmeans_edges(col: torch.Tensor, n_bins: int) -> torch.Tensor:
  """Bin edges (the column's dtype) between 1-D k-means centres started
  at the centres of the uniform bins."""
  col = _subsampled(col)
  lo, hi = (float(v) for v in torch.aminmax(col))
  np_dtype = np.float32 if col.dtype == torch.float32 else np.float64
  uniform = np.linspace(np_dtype(lo), np_dtype(hi), n_bins + 1)
  init = (uniform[1:] + uniform[:-1])[:, None] * 0.5
  km = KMeans(n_clusters=n_bins, init=init, n_init=1).fit(col[:, None])
  centers = torch.sort(km.cluster_centers_[:, 0]).values
  mids = (centers[1:] + centers[:-1]) * 0.5
  ends = torch.tensor([lo, hi], dtype=col.dtype, device=col.device)
  return _drop_narrow(torch.cat([ends[:1], mids, ends[1:]]))


def bins_of(col: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
  """Each row's bin (int64): ``searchsorted(edges[1:-1], x, 'right')``."""
  inner = edges[1:-1].to(torch.float64)
  return torch.searchsorted(inner, col.to(torch.float64).contiguous(),
                            right=True)


class GaussianMixture:
  """scikit-learn's ``GaussianMixture`` on one feature (full covariance,
  k-means initialisation), fitted by ``fit_predict``."""

  def __init__(self, n_components: int = 1, *, tol: float = 1e-3,
               reg_covar: float = 1e-6, max_iter: int = 100,
               random_state=None):
    self.n_components = int(n_components)
    self.tol = float(tol)
    self.reg_covar = float(reg_covar)
    self.max_iter = int(max_iter)
    self.random_state = random_state

  def _params(self, x: torch.Tensor, resp: torch.Tensor):
    eps = 10 * torch.finfo(resp.dtype).eps
    nk = resp.sum(0) + eps
    means = (resp.T @ x[:, None])[:, 0] / nk
    var = (resp * (x[:, None] - means[None]) ** 2).sum(0) / nk + self.reg_covar
    return nk, means, var

  def _e_step(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    prec = 1.0 / torch.sqrt(self.covariances_)
    y = x[:, None] * prec[None] - (self.means_ * prec)[None]
    log_prob = (-0.5 * (math.log(2 * math.pi) + y * y) + torch.log(prec)[None]
                + torch.log(self.weights_)[None])
    norm = torch.logsumexp(log_prob, dim=1)
    return norm.mean(), log_prob - norm[:, None]

  def fit_predict(self, X) -> torch.Tensor:
    x = X.reshape(-1)
    if not x.is_floating_point():
      x = x.to(torch.float64)
    n = x.shape[0]
    if n < self.n_components:
      raise ValueError(f"Expected n_samples >= n_components but got "
                       f"n_components = {self.n_components}, "
                       f"n_samples = {n}")
    rng = self.random_state if isinstance(
        self.random_state, np.random.RandomState) else \
        np.random.RandomState(self.random_state)
    labels = KMeans(n_clusters=self.n_components, n_init=1,
                    random_state=rng).fit(x[:, None]).labels_
    resp = torch.nn.functional.one_hot(labels, self.n_components).to(x.dtype)
    nk, self.means_, self.covariances_ = self._params(x, resp)
    self.weights_ = nk / n
    lower = -math.inf
    self.converged_ = False
    for n_iter in range(1, self.max_iter + 1):
      previous = lower
      norm, log_resp = self._e_step(x)
      nk, self.means_, self.covariances_ = self._params(x, torch.exp(log_resp))
      self.weights_ = nk / nk.sum()
      lower = float(norm)
      if abs(lower - previous) < self.tol:
        self.converged_ = True
        break
    self.n_iter_ = n_iter
    self.lower_bound_ = lower
    return torch.argmax(self._e_step(x)[1], dim=1)

  def model(self) -> Dict[str, torch.Tensor]:
    """The fitted means, variances and weights."""
    return dict(means=self.means_, covariances=self.covariances_,
                weights=self.weights_)
