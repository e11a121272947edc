"""scikit-learn 1.9's ``GaussianMixture`` carried in torch, on the device
of its input (``sklearn/mixture/_gaussian_mixture.py``, ``_base.py``).

As scikit-learn: every covariance type (``full``, ``tied``, ``diag``,
``spherical``); the responsibilities start from the labels of
``KMeans(n_components, n_init=1, random_state)`` (the port's
``ml/cluster.py``, which replays scikit-learn's draws) unless all of
``weights_init``/``means_init``/``precisions_init`` are given; ``reg_covar``
on the diagonal; EM until the mean log-likelihood moves by less than
``tol`` or ``max_iter``; ``score_samples``, ``score``, ``predict``,
``predict_proba``, ``bic`` and ``aic``.  A float32 input is fitted in
float32 and any other in float64, as scikit-learn does; a covariance that
is not positive raises ``ValueError`` as scikit-learn's does.

``fit_batch`` fits B independent mixtures on (B, n, d) data at once, each
from its own k-means and each stopping on its own: a mixture that has
converged keeps its parameters while the others go on.  Its fitted
arrays keep the batch axis; those of ``fit`` do not.  ``n_init`` > 1 is
not ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from odin_tpu_torch.device import as_tensor, device_of
from odin_tpu_torch.ml.gmm_tmat import ieee_fp32_matmuls

__all__ = ["GaussianMixture"]

COVARIANCE_TYPES = ("full", "tied", "diag", "spherical")
_ILL_DEFINED = ("Fitting the mixture model failed because some components "
                "have ill-defined empirical covariance (for instance caused "
                "by singleton or collapsed samples). Try to decrease the "
                "number of components, increase reg_covar, or scale the "
                "input data.")


def _float(X, device=None) -> torch.Tensor:
  X = as_tensor(X, device_of(X, device=device))
  return X if X.dtype in (torch.float32, torch.float64) else \
      X.to(torch.float64)


class GaussianMixture:
  """scikit-learn's ``GaussianMixture`` (see the module docstring)."""

  def __init__(self, n_components: int = 1, *, covariance_type: str = "full",
               tol: float = 1e-3, reg_covar: float = 1e-6,
               max_iter: int = 100, n_init: int = 1,
               init_params: str = "kmeans", weights_init=None,
               means_init=None, precisions_init=None, random_state=None,
               device=None):
    if covariance_type not in COVARIANCE_TYPES:
      raise ValueError(f"covariance_type must be one of {COVARIANCE_TYPES}")
    if n_init != 1 or init_params != "kmeans":
      raise NotImplementedError("only n_init=1 and init_params='kmeans' are "
                                "ported")
    self.n_components = int(n_components)
    self.covariance_type = covariance_type
    self.tol = float(tol)
    self.reg_covar = float(reg_covar)
    self.max_iter = int(max_iter)
    self.n_init = 1
    self.init_params = init_params
    self.weights_init = weights_init
    self.means_init = means_init
    self.precisions_init = precisions_init
    self.random_state = random_state
    self.device = device
    self._batched = False

  # -- the model's algebra over a batch of mixtures ---------------------------
  def _parameters(self, X, resp):
    """scikit-learn's ``_estimate_gaussian_parameters`` for X (B, n, d) and
    resp (B, n, K): (nk (B, K), means (B, K, d), covariances)."""
    eps = 10 * torch.finfo(resp.dtype).eps
    nk = resp.sum(1) + eps
    means = resp.transpose(1, 2) @ X / nk[:, :, None]
    d = X.shape[2]
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    t = self.covariance_type
    if t == "full":
      diff = X[:, None] - means[:, :, None]  # (B, K, n, d)
      cov = (resp.transpose(1, 2)[..., None] * diff).transpose(2, 3) @ diff
      cov = cov / nk[:, :, None, None] + self.reg_covar * eye
    elif t == "tied":
      avg_X2 = X.transpose(1, 2) @ X
      avg_means2 = (nk[:, None, :] * means.transpose(1, 2)) @ means
      cov = (avg_X2 - avg_means2) / nk.sum(1)[:, None, None] + \
          self.reg_covar * eye
    else:
      avg_X2 = resp.transpose(1, 2) @ (X * X) / nk[:, :, None]
      cov = avg_X2 - means ** 2 + self.reg_covar
      if t == "spherical":
        cov = cov.mean(2)
    return nk, means, cov

  def _precision_cholesky(self, cov, active):
    t = self.covariance_type
    if t in ("full", "tied"):
      chol, info = torch.linalg.cholesky_ex(cov)
      if bool((info.reshape(info.shape[0], -1).ne(0).any(1) & active).any()):
        raise ValueError(_ILL_DEFINED)
      eye = torch.eye(cov.shape[-1], dtype=cov.dtype,
                      device=cov.device).expand_as(chol)
      return torch.linalg.solve_triangular(chol, eye, upper=False
                                           ).transpose(-1, -2)
    bad = (cov <= 0.0).reshape(cov.shape[0], -1).any(1) & active
    if bool(bad.any()):
      raise ValueError(_ILL_DEFINED)
    return 1.0 / torch.sqrt(cov)

  def _log_gaussian(self, X, means, prec_chol):
    """(B, n, K) log N(x | μ_k, Σ_k)."""
    B, n, d = X.shape
    t = self.covariance_type
    if t == "full":
      log_det = torch.log(torch.diagonal(prec_chol, dim1=2, dim2=3)).sum(2)
      y = X[:, None] @ prec_chol - (means[:, :, None] @ prec_chol)
      log_prob = (y * y).sum(3).transpose(1, 2)
    elif t == "tied":
      log_det = torch.log(torch.diagonal(prec_chol, dim1=1, dim2=2)).sum(1)
      log_det = log_det[:, None]
      y = (X @ prec_chol)[:, None] - (means @ prec_chol)[:, :, None]
      log_prob = (y * y).sum(3).transpose(1, 2)
    elif t == "diag":
      log_det = torch.log(prec_chol).sum(2)
      prec = prec_chol ** 2
      log_prob = ((means ** 2 * prec).sum(2)[:, None] -
                  2.0 * (X @ (means * prec).transpose(1, 2)) +
                  (X ** 2) @ prec.transpose(1, 2))
    else:
      log_det = d * torch.log(prec_chol)
      prec = prec_chol ** 2
      log_prob = ((means ** 2).sum(2)[:, None] * prec[:, None] -
                  2.0 * (X @ means.transpose(1, 2)) * prec[:, None] +
                  (X * X).sum(2)[:, :, None] * prec[:, None])
    return -0.5 * (d * math.log(2 * math.pi) + log_prob) + log_det[:, None]

  def _weighted(self, X, means, prec_chol, weights):
    return self._log_gaussian(X, means, prec_chol) + \
        torch.log(weights)[:, None]

  # -- fitting ----------------------------------------------------------------
  def _kmeans_resp(self, X):
    from odin_tpu_torch.ml.cluster import KMeans
    B, n, _ = X.shape
    labels = torch.stack([KMeans(
        self.n_components, n_init=1, random_state=np.random.RandomState(
            self.random_state) if not isinstance(
                self.random_state, np.random.RandomState)
        else self.random_state).fit(X[b]).labels_ for b in range(B)])
    return torch.nn.functional.one_hot(labels, self.n_components).to(
        X.dtype)

  def _initial(self, X):
    B, n, d = X.shape
    dt, dev = X.dtype, X.device
    given = [None if a is None else
             torch.as_tensor(np.asarray(a), dtype=dt).to(dev).expand(
                 B, *np.shape(a)).clone()
             for a in (self.weights_init, self.means_init,
                       self.precisions_init)]
    w0, m0, p0 = given
    if w0 is not None and m0 is not None and p0 is not None:
      return w0, m0, self._chol_from_precisions(p0)
    nk, means, cov = self._parameters(X, self._kmeans_resp(X))
    weights = nk / n if w0 is None else w0
    means = means if m0 is None else m0
    active = torch.ones(B, dtype=torch.bool, device=dev)
    prec_chol = self._precision_cholesky(cov, active) if p0 is None else \
        self._chol_from_precisions(p0)
    return weights, means, prec_chol

  def _chol_from_precisions(self, prec):
    if self.covariance_type in ("full", "tied"):
      return torch.linalg.cholesky(prec)
    return torch.sqrt(prec)

  def fit(self, X, y=None) -> "GaussianMixture":
    X = _float(X, self.device)
    self._fit(X[None])
    self._batched = False
    return self

  def fit_batch(self, X) -> "GaussianMixture":
    """Fit one mixture to each of the B datasets of X (B, n, d)."""
    X = _float(X, self.device)
    self._fit(X)
    self._batched = True
    return self

  def _fit(self, X):
    B, n, d = X.shape
    if n < 2:
      raise ValueError(f"Found array with {n} sample(s) while a minimum of "
                       "2 is required.")
    if n < self.n_components:
      raise ValueError("Expected n_samples >= n_components but got "
                       f"n_components = {self.n_components}, "
                       f"n_samples = {n}")
    dev = X.device
    with ieee_fp32_matmuls():
      weights, means, prec_chol = self._initial(X)
      lower = torch.full((B,), -math.inf, dtype=torch.float64, device=dev)
      active = torch.ones(B, dtype=torch.bool, device=dev)
      n_iter = torch.zeros(B, dtype=torch.long, device=dev)
      cov = None
      for it in range(1, self.max_iter + 1):
        weighted = self._weighted(X, means, prec_chol, weights)
        norm = torch.logsumexp(weighted, dim=2)
        resp = torch.exp(weighted - norm[:, :, None])
        nk, new_means, new_cov = self._parameters(X, resp)
        new_prec = self._precision_cholesky(new_cov, active)
        new_lower = norm.mean(1).to(torch.float64)
        sel = lambda a, b: torch.where(
            active.reshape((B,) + (1,) * (a.dim() - 1)), a, b)
        weights = sel(nk / nk.sum(1, keepdim=True), weights)
        means = sel(new_means, means)
        cov = new_cov if cov is None else sel(new_cov, cov)
        prec_chol = sel(new_prec, prec_chol)
        change = new_lower - lower
        lower = sel(new_lower, lower)
        n_iter = torch.where(active, torch.full_like(n_iter, it), n_iter)
        active = active & ~(change.abs() < self.tol)
        if not bool(active.any()):
          break
    self._weights, self._means, self._prec_chol = weights, means, prec_chol
    self._covariances = cov
    self._converged = ~active
    self._n_iter = n_iter
    self._lower = lower

  # -- the fitted state, with or without the batch axis -----------------------
  def _one(self, a):
    return a if self._batched else a[0]

  @property
  def weights_(self):
    return self._one(self._weights)

  @property
  def means_(self):
    return self._one(self._means)

  @property
  def covariances_(self):
    return self._one(self._covariances)

  @property
  def precisions_cholesky_(self):
    return self._one(self._prec_chol)

  @property
  def precisions_(self):
    pc = self._prec_chol
    if self.covariance_type in ("full", "tied"):
      return self._one(pc @ pc.transpose(-1, -2))
    return self._one(pc ** 2)

  @property
  def converged_(self):
    return self._one(self._converged) if self._batched else \
        bool(self._converged[0])

  @property
  def n_iter_(self):
    return self._n_iter if self._batched else int(self._n_iter[0])

  @property
  def lower_bound_(self):
    return self._lower if self._batched else float(self._lower[0])

  def set_state(self, weights, means, covariances, precisions_cholesky,
                batched: bool = False, device=None) -> "GaussianMixture":
    """Load fitted parameters (scikit-learn's ``weights_``, ``means_``,
    ``covariances_``, ``precisions_cholesky_``; with a leading batch axis
    where `batched`)."""
    dev = device_of(weights, device=device or self.device)
    arrs = [torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                            else a).to(dev)
            for a in (weights, means, covariances, precisions_cholesky)]
    if not batched:
      arrs = [a[None] for a in arrs]
    (self._weights, self._means, self._covariances,
     self._prec_chol) = arrs
    B = arrs[0].shape[0]
    self._converged = torch.ones(B, dtype=torch.bool, device=dev)
    self._n_iter = torch.zeros(B, dtype=torch.long, device=dev)
    self._lower = torch.full((B,), math.nan, dtype=torch.float64, device=dev)
    self._batched = batched
    return self

  # -- prediction ---------------------------------------------------------------
  def _input(self, X) -> torch.Tensor:
    X = as_tensor(X, self._means.device)
    X = X.to(self._means.dtype)
    return X if self._batched else X[None]

  def _weighted_log_prob(self, X) -> torch.Tensor:
    with ieee_fp32_matmuls():
      return self._weighted(self._input(X), self._means, self._prec_chol,
                            self._weights)

  def score_samples(self, X) -> torch.Tensor:
    return self._one(torch.logsumexp(self._weighted_log_prob(X), dim=2))

  def score(self, X, y=None):
    s = self.score_samples(X).mean(-1)
    return s if self._batched else float(s)

  def predict(self, X) -> torch.Tensor:
    return self._one(torch.argmax(self._weighted_log_prob(X), dim=2))

  def predict_proba(self, X) -> torch.Tensor:
    w = self._weighted_log_prob(X)
    return self._one(torch.exp(w - torch.logsumexp(w, dim=2, keepdim=True)))

  def _n_parameters(self) -> int:
    d = self._means.shape[2]
    K = self.n_components
    cov = {"full": K * d * (d + 1) / 2.0, "diag": K * d,
           "tied": d * (d + 1) / 2.0, "spherical": K}[self.covariance_type]
    return int(cov + d * K + K - 1)

  def bic(self, X):
    n = self._input(X).shape[1]
    s = self.score(X)
    return -2 * s * n + self._n_parameters() * math.log(n)

  def aic(self, X):
    n = self._input(X).shape[1]
    return -2 * self.score(X) * n + 2 * self._n_parameters()
