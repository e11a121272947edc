"""scikit-learn 1.9's ``LinearDiscriminantAnalysis`` carried in torch, on
the device of its input (``sklearn/discriminant_analysis.py``).

Only the ``svd`` solver is ported: scikit-learn's default and the only one
the JAX package's callers use (``VectorNormalizer(lda=True)``,
``SupervisedPPCA``, ``linear_classifier('lda')``).  As scikit-learn: the
priors are the class shares (or given), ``n_components`` is at most
``min(K − 1, d)``; a float32 input is fitted in float32 and any other in
float64; the within-class scatter is whitened by the SVD of the
standardised centred rows (ranks above ``tol``), then the class means by a
second SVD (ranks above ``tol`` times the largest singular value).

The signs of ``scalings_`` come from the SVD and are no convention, so
``transform`` may differ from scikit-learn's by the sign of each column;
``coef_``, ``intercept_``, ``decision_function`` and the probabilities
do not depend on those signs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from odin_tpu_torch.device import as_tensor, device_of
from odin_tpu_torch.ml.gmm_tmat import ieee_fp32_matmuls

__all__ = ["LinearDiscriminantAnalysis"]


def _float(X, device=None) -> torch.Tensor:
  """X as a float32 or float64 tensor (other dtypes become float64) on
  `device`, X's own, or the card."""
  X = as_tensor(X, device_of(X, device=device))
  return X if X.dtype in (torch.float32, torch.float64) else \
      X.to(torch.float64)


def _labels(y) -> np.ndarray:
  if isinstance(y, torch.Tensor):
    y = y.detach().cpu().numpy()
  return np.asarray(y).ravel()


class LinearDiscriminantAnalysis:
  """scikit-learn's ``LinearDiscriminantAnalysis(solver='svd')`` (see the
  module docstring); the fitted arrays are tensors on the input's device,
  ``classes_`` a numpy array."""

  def __init__(self, solver: str = "svd", priors=None,
               n_components: Optional[int] = None, tol: float = 1e-4,
               device=None):
    if solver != "svd":
      raise NotImplementedError(f"solver={solver!r}: only 'svd' is ported")
    self.solver = solver
    self.priors = priors
    self.n_components = n_components
    self.tol = float(tol)
    self.device = device

  def fit(self, X, y) -> "LinearDiscriminantAnalysis":
    X = _float(X, self.device)
    dev, dt = X.device, X.dtype
    self.classes_, yi = np.unique(_labels(y), return_inverse=True)
    n, d = X.shape
    K = len(self.classes_)
    if n == K:
      raise ValueError("The number of samples must be more than the number "
                       "of classes.")
    yi_t = torch.from_numpy(yi.ravel()).to(dev)
    counts = torch.bincount(yi_t, minlength=K)
    if self.priors is None:
      self.priors_ = counts.to(dt) / float(n)
    else:
      self.priors_ = torch.as_tensor(np.asarray(self.priors), dtype=dt,
                                     device=dev)
      if abs(float(self.priors_.sum()) - 1.0) > 1e-5:
        self.priors_ = self.priors_ / self.priors_.sum()
    max_components = min(K - 1, d)
    if self.n_components is not None and self.n_components > max_components:
      raise ValueError("n_components cannot be larger than min(n_features, "
                       "n_classes - 1).")
    self._max_components = (max_components if self.n_components is None
                            else int(self.n_components))
    with ieee_fp32_matmuls():
      self._solve_svd(X, yi_t, counts)
    if K == 2:
      self.coef_ = (self.coef_[1] - self.coef_[0])[None]
      self.intercept_ = (self.intercept_[1] - self.intercept_[0])[None]
    return self

  def _solve_svd(self, X, yi, counts):
    n = X.shape[0]
    K = len(self.classes_)
    dt = X.dtype
    self.means_ = torch.zeros(K, X.shape[1], dtype=torch.float64,
                              device=X.device).index_add_(
                                  0, yi, X.to(torch.float64)).to(dt) / \
        counts.to(dt)[:, None]
    Xc = X - self.means_[yi]
    self.xbar_ = self.priors_ @ self.means_
    std = Xc.std(0, correction=0)
    std = torch.where(std == 0, torch.ones_like(std), std)
    fac = torch.tensor(1.0 / (n - K), dtype=dt, device=X.device)
    _, S, Vt = torch.linalg.svd(torch.sqrt(fac) * (Xc / std),
                                full_matrices=False)
    rank = int((S > self.tol).sum())
    scalings = (Vt[:rank] / std).T / S[:rank]
    fac = 1.0 if K == 1 else 1.0 / (K - 1)
    M = (torch.sqrt((n * self.priors_) * fac) *
         (self.means_ - self.xbar_).T).T @ scalings
    _, S, Vt = torch.linalg.svd(M, full_matrices=False)
    self.explained_variance_ratio_ = (S ** 2 / torch.sum(S ** 2))[
        :self._max_components]
    rank = int((S > self.tol * S[0]).sum())
    self.scalings_ = scalings @ Vt.T[:, :rank]
    coef = (self.means_ - self.xbar_) @ self.scalings_
    self.intercept_ = -0.5 * torch.sum(coef ** 2, 1) + torch.log(self.priors_)
    self.coef_ = coef @ self.scalings_.T
    self.intercept_ = self.intercept_ - self.xbar_ @ self.coef_.T

  def _input(self, X) -> torch.Tensor:
    X = as_tensor(X, self.coef_.device)
    return X if X.is_floating_point() else X.to(torch.float64)

  def transform(self, X) -> torch.Tensor:
    X = self._input(X)
    with ieee_fp32_matmuls():
      return ((X - self.xbar_) @ self.scalings_)[:, :self._max_components]

  def fit_transform(self, X, y) -> torch.Tensor:
    return self.fit(X, y).transform(X)

  def decision_function(self, X) -> torch.Tensor:
    X = self._input(X)
    with ieee_fp32_matmuls():
      scores = X @ self.coef_.T + self.intercept_
    return scores[:, 0] if scores.shape[1] == 1 else scores

  def predict(self, X) -> np.ndarray:
    scores = self.decision_function(X)
    idx = (scores > 0).long() if scores.ndim == 1 else torch.argmax(scores, 1)
    return self.classes_[idx.cpu().numpy()]

  def predict_proba(self, X) -> torch.Tensor:
    scores = self.decision_function(X)
    if scores.ndim == 1:
      p = torch.sigmoid(scores)
      return torch.stack([1 - p, p], 1)
    return torch.softmax(scores, 1)

  def predict_log_proba(self, X) -> torch.Tensor:
    p = self.predict_proba(X)
    tiny = torch.finfo(p.dtype).tiny
    return torch.log(torch.where(p == 0.0, p + tiny, p))

  def score(self, X, y) -> float:
    return float(np.mean(self.predict(X) == _labels(y)))
