"""Decompositions of the port (PyTorch port of
``odin_tpu/ml/decompositions.py``), on the device of their input (the card
for an array unless `device` says otherwise).

The JAX package wraps scikit-learn's ``PCA`` and ``IncrementalPCA``; the
card's machine has none, so both are carried here after scikit-learn
1.9's code (``sklearn/decomposition/_pca.py``, ``_incremental_pca.py``,
``sklearn/utils/extmath.py``):

- ``PCA``: the ``auto`` solver's choice (``covariance_eigh`` for at most
  1000 features and at least 10x as many rows, ``full`` when the larger
  side is at most 500, ``randomized`` for 1 <= n_components < 0.8·min
  side, else ``full``); the randomized route's Gaussian sketch drawn by a
  numpy ``RandomState(random_state)`` on the host, ``n_iter='auto'`` (7
  below a tenth of the smaller side, else 4), LU power iterations (none
  for at most 2) and the final QR; ``svd_flip(u_based_decision=False)``,
  so each component's largest entry is positive and the components match
  scikit-learn's to rounding; ``explained_variance_`` with ddof 1,
  ``whiten``, ``inverse_transform``.  A float32 input stays float32, as
  in scikit-learn, and any other input is float64.
- ``IncrementalPCA``: the running mean and variance in float64, the SVD of
  the previous components scaled by their singular values stacked over
  the centred batch and the mean-correction row (float64 from the second
  batch on), ``svd_flip``; ``fit`` in batches of ``batch_size`` (5x the
  features by default), the last batch merged into the one before it
  where it would hold fewer rows than ``n_components``.  A tall stacked
  matrix is reduced by QR first, which leaves its singular values and
  right vectors as they were.

Then the JAX package's own classes: ``fast_pca``, ``PPCA`` (EM in float32
from ``RandomState(random_state).randn(d, q)·0.1``, stopping when σ²
moves by less than ``tol`` times the data's variance), ``SupervisedPPCA``
(PPCA, then ``LinearDiscriminantAnalysis`` on its latents),
``MiniBatchPCA`` and ``RandomizedPCA`` (its Gaussian sketch from a
``torch.Generator``, or given; no sign convention, as in JAX; whitening by
√(n − 1)).

Every float32 matmul runs with TF32 off (``ieee_fp32_matmuls``).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from odin_tpu_torch.device import as_tensor, device_of
from odin_tpu_torch.ml.discriminant import LinearDiscriminantAnalysis
from odin_tpu_torch.ml.gmm_tmat import ieee_fp32_matmuls

__all__ = ["PCA", "IncrementalPCA", "fast_pca", "PPCA", "SupervisedPPCA",
           "MiniBatchPCA", "RandomizedPCA", "svd_flip"]

F64 = torch.float64


def _float(X, device=None) -> torch.Tensor:
  """X as a float32 or float64 tensor (other dtypes become float64)."""
  X = as_tensor(X, device_of(X, device=device))
  return X if X.dtype in (torch.float32, torch.float64) else X.to(F64)


def svd_flip(Vt: torch.Tensor, U: Optional[torch.Tensor] = None):
  """scikit-learn's ``svd_flip(u_based_decision=False)``: each row of Vt
  (and the matching column of U) signed so that its largest |entry| (the
  first of equals) is positive.  Returns (U, Vt)."""
  pick = torch.argmax(Vt.abs(), dim=1)
  signs = torch.sign(Vt.gather(1, pick[:, None]))
  return (None if U is None else U * signs[:, 0][None]), Vt * signs


def _right_svd(A: torch.Tensor):
  """(S, Vt) of A's thin SVD; a tall A is reduced to the R of its QR
  first (the same S and Vt, far less work)."""
  if A.shape[0] > 2 * A.shape[1]:
    A = torch.linalg.qr(A, mode="r")[1]
  _, S, Vt = torch.linalg.svd(A, full_matrices=False)
  return S, Vt


def _permuted_l(B: torch.Tensor) -> torch.Tensor:
  """scipy's ``lu(B, permute_l=True)[0]``: P·L of B = P·L·U (partial
  pivoting), for a tall B, without forming the (m, m) permutation."""
  LU, pivots = torch.linalg.lu_factor(B)
  m, k = B.shape
  L = torch.tril(LU[:, :k], -1)
  L[:k].diagonal().fill_(1.0)
  perm = np.arange(m)
  for i, p in enumerate(pivots.cpu().numpy() - 1):  # LAPACK's row swaps
    perm[i], perm[p] = perm[p], perm[i]
  out = torch.empty_like(L)
  out[torch.from_numpy(perm).to(B.device)] = L
  return out


class PCA:
  """scikit-learn's ``PCA`` (see the module docstring); the fitted arrays
  are tensors on the input's device.  ``arpack`` is not ported."""

  def __init__(self, n_components=None, *, copy: bool = True,
               whiten: bool = False, svd_solver: str = "auto",
               tol: float = 0.0, iterated_power="auto",
               n_oversamples: int = 10, power_iteration_normalizer="auto",
               random_state=None, device=None):
    if svd_solver not in ("auto", "full", "covariance_eigh", "randomized"):
      raise NotImplementedError(f"svd_solver={svd_solver!r} is not ported")
    self.n_components = n_components
    self.copy = copy
    self.whiten = bool(whiten)
    self.svd_solver = svd_solver
    self.tol = tol
    self.iterated_power = iterated_power
    self.n_oversamples = int(n_oversamples)
    self.power_iteration_normalizer = power_iteration_normalizer
    self.random_state = random_state
    self.device = device

  def _solver(self, n, d, k) -> str:
    if self.svd_solver != "auto":
      return self.svd_solver
    if d <= 1000 and n >= 10 * d:
      return "covariance_eigh"
    if max(n, d) <= 500 or k == "mle":
      return "full"
    if 1 <= k < 0.8 * min(n, d):
      return "randomized"
    return "full"

  def fit(self, X, y=None) -> "PCA":
    X = _float(X, self.device)
    n, d = X.shape
    k = min(n, d) if self.n_components is None else self.n_components
    if isinstance(k, str) or (isinstance(k, float) and 0 < k < 1):
      raise NotImplementedError(f"n_components={k!r} is not ported")
    k = int(k)
    self._fit_svd_solver = self._solver(n, d, k)
    with ieee_fp32_matmuls():
      if self._fit_svd_solver == "randomized":
        self._fit_randomized(X, k)
      else:
        self._fit_full(X, k)
    return self

  def _fit_full(self, X, k):
    n, d = X.shape
    self.mean_ = X.mean(0)
    if self._fit_svd_solver == "full":
      _, S, Vt = torch.linalg.svd(X - self.mean_, full_matrices=False)
      explained = S ** 2 / (n - 1)
    else:  # covariance_eigh, in X's dtype as scikit-learn computes it
      C = X.T @ X
      C = C - n * self.mean_[:, None] * self.mean_[None, :]
      C = C / (n - 1)
      evals, evecs = torch.linalg.eigh(C)
      evals = torch.clamp(torch.flip(evals, [0]), min=0.0)
      explained = evals
      S = torch.sqrt(evals * (n - 1))
      Vt = torch.flip(evecs, [1]).T
    _, Vt = svd_flip(Vt)
    total = explained.sum()
    self.noise_variance_ = (explained[k:].mean() if k < min(n, d)
                            else torch.zeros((), dtype=X.dtype,
                                             device=X.device))
    self._set(n, k, Vt[:k], explained[:k], explained[:k] / total, S[:k])

  def _fit_randomized(self, X, k):
    n, d = X.shape
    self.mean_ = X.mean(0)
    M = X - self.mean_
    n_random = k + self.n_oversamples
    n_iter = self.iterated_power
    if n_iter == "auto":
      n_iter = 7 if k < 0.1 * min(n, d) else 4
    transpose = n < d
    A = M.T if transpose else M
    rng = (self.random_state if isinstance(self.random_state,
                                           np.random.RandomState)
           else np.random.RandomState(self.random_state))
    Q = rng.normal(size=(A.shape[1], n_random))
    Q = torch.from_numpy(Q).to(device=X.device, dtype=X.dtype)
    norm = self.power_iteration_normalizer
    if norm == "auto":
      norm = "none" if n_iter <= 2 else "LU"

    def normalise(B):
      if norm == "QR":
        return torch.linalg.qr(B)[0]
      if norm == "LU":
        return _permuted_l(B)
      return B

    for _ in range(int(n_iter)):
      Q = normalise(A @ Q)
      Q = normalise(A.T @ Q)
    Q = torch.linalg.qr(A @ Q)[0]
    Uhat, S, Vt = torch.linalg.svd(Q.T @ A, full_matrices=False)
    if transpose:  # M = (Q·Uhat·S·Vt)ᵀ: M's right vectors are Q·Uhat
      Vt = (Q @ Uhat)[:, :k].T
    S, Vt = S[:k], Vt[:k]
    _, Vt = svd_flip(Vt)
    explained = S ** 2 / (n - 1)
    total = (M * M).sum() / (n - 1)
    self.noise_variance_ = ((total - explained.sum()) / (min(n, d) - k)
                            if k < min(n, d) else
                            torch.zeros((), dtype=X.dtype, device=X.device))
    self._set(n, k, Vt, explained, explained / total, S)

  def _set(self, n, k, Vt, explained, ratio, S):
    self.n_samples_ = n
    self.n_components_ = k
    self.n_features_in_ = Vt.shape[1]
    self.components_ = Vt.contiguous()
    self.explained_variance_ = explained
    self.explained_variance_ratio_ = ratio
    self.singular_values_ = S

  def _input(self, X) -> torch.Tensor:
    X = as_tensor(X, self.components_.device)
    return X if X.is_floating_point() else X.to(F64)

  def transform(self, X) -> torch.Tensor:
    X = self._input(X)
    comps = self.components_.to(X.dtype)
    with ieee_fp32_matmuls():
      out = X @ comps.T - self.mean_.to(X.dtype)[None] @ comps.T
    if self.whiten:
      scale = torch.sqrt(self.explained_variance_)
      tiny = torch.finfo(scale.dtype).eps
      out = out / torch.where(scale < tiny, torch.full_like(scale, tiny),
                              scale)
    return out

  def fit_transform(self, X, y=None) -> torch.Tensor:
    return self.fit(X).transform(X)

  def inverse_transform(self, X) -> torch.Tensor:
    X = self._input(X)
    comps = self.components_
    if self.whiten:
      comps = torch.sqrt(self.explained_variance_)[:, None] * comps
    with ieee_fp32_matmuls():
      return X @ comps.to(X.dtype) + self.mean_.to(X.dtype)


def _gen_batches(n: int, batch_size: int, min_batch_size: int = 0):
  """scikit-learn's ``gen_batches``."""
  start = 0
  for _ in range(n // batch_size):
    end = start + batch_size
    if end + min_batch_size > n:
      continue
    yield slice(start, end)
    start = end
  if start < n:
    yield slice(start, n)


class IncrementalPCA:
  """scikit-learn's ``IncrementalPCA`` (see the module docstring); the
  fitted arrays are tensors on `device` (the first batch's device when
  None)."""

  def __init__(self, n_components: Optional[int] = None, *,
               whiten: bool = False, copy: bool = True,
               batch_size: Optional[int] = None, device=None):
    if whiten:
      raise NotImplementedError("IncrementalPCA(whiten=True) is not ported")
    self.n_components = n_components
    self.whiten = False
    self.copy = copy
    self.batch_size = batch_size
    self.device = device
    self._reset()

  def _reset(self):
    self.components_ = None
    self.n_samples_seen_ = 0
    self.mean_ = None
    self.var_ = None
    self.singular_values_ = None
    self.explained_variance_ = None
    self.explained_variance_ratio_ = None
    self.noise_variance_ = None

  def fit(self, X, y=None) -> "IncrementalPCA":
    self._reset()
    X = _float(X, self.device)
    n, d = X.shape
    self.batch_size_ = 5 * d if self.batch_size is None else \
        int(self.batch_size)
    for batch in _gen_batches(n, self.batch_size_,
                              min_batch_size=self.n_components or 0):
      self.partial_fit(X[batch])
    return self

  def partial_fit(self, X, y=None) -> "IncrementalPCA":
    X = _float(X, self.device if self.mean_ is None else self.mean_.device)
    n, d = X.shape
    first = self.components_ is None
    if self.n_components is None:
      self.n_components_ = min(n, d) if first else self.components_.shape[0]
    elif self.n_components > d:
      raise ValueError(f"n_components={self.n_components} invalid for "
                       f"n_features={d}, need more rows than columns for "
                       "IncrementalPCA processing")
    elif self.n_components > n and first:
      raise ValueError(f"n_components={self.n_components} must be less or "
                       f"equal to the batch number of samples {n} for the "
                       "first partial_fit call.")
    else:
      self.n_components_ = int(self.n_components)
    k = self.n_components_
    seen = self.n_samples_seen_
    total = seen + n
    # the running mean and variance (scikit-learn's
    # _incremental_mean_and_var), in float64
    new_sum = X.sum(0, dtype=F64)
    centred = X.to(F64) - new_sum / n
    correction = centred.sum(0)
    new_unnormalized = (centred ** 2).sum(0) - correction ** 2 / n
    if seen == 0:
      mean = new_sum / total
      unnormalized = new_unnormalized
    else:
      last_sum = self.mean_ * seen
      mean = (last_sum + new_sum) / total
      last_over_new = seen / n
      unnormalized = (self.var_ * seen + new_unnormalized +
                      last_over_new / total *
                      (last_sum / last_over_new - new_sum) ** 2)
    var = unnormalized / total
    with ieee_fp32_matmuls():
      if seen == 0:
        stacked = (X.to(F64) - mean).to(X.dtype)
      else:
        batch_mean = X.mean(0)
        mean_correction = (math.sqrt(seen / total * n) *
                           (self.mean_ - batch_mean.to(F64)))
        # the float64 correction row makes the stacked matrix float64
        stacked = torch.cat([
            (self.singular_values_[:, None] * self.components_).to(F64),
            (X - batch_mean).to(F64), mean_correction[None]])
      S, Vt = _right_svd(stacked.to(F64))
    _, Vt = svd_flip(Vt)
    S, Vt = S.to(stacked.dtype), Vt.to(stacked.dtype)
    explained = S.to(F64) ** 2 / (total - 1)
    ratio = S.to(F64) ** 2 / torch.sum(var * total)
    self.n_samples_seen_ = total
    self.components_ = Vt[:k].contiguous()
    self.singular_values_ = S[:k]
    self.mean_ = mean
    self.var_ = var
    self.explained_variance_ = explained[:k]
    self.explained_variance_ratio_ = ratio[:k]
    self.noise_variance_ = (explained[k:].mean() if k not in (n, d)
                            else torch.zeros((), dtype=F64,
                                             device=X.device))
    return self

  def transform(self, X) -> torch.Tensor:
    """(X − mean) @ componentsᵀ, in the components' dtype."""
    comps = self.components_
    X = as_tensor(X, comps.device)
    dt = torch.promote_types(X.dtype, comps.dtype) \
        if X.is_floating_point() else F64
    with ieee_fp32_matmuls():
      return X.to(dt) @ comps.to(dt).T - self.mean_.to(dt)[None] @ \
          comps.to(dt).T

  def fit_transform(self, X, y=None) -> torch.Tensor:
    return self.fit(X).transform(X)

  def inverse_transform(self, X) -> torch.Tensor:
    X = as_tensor(X, self.components_.device)
    with ieee_fp32_matmuls():
      return X @ self.components_.to(X.dtype) + self.mean_.to(X.dtype)


def fast_pca(*x, n_components: Optional[int] = None, algo: str = "pca",
             random_state: int = 1, return_model: bool = False,
             device=None, **kwargs):
  """Fit ``PCA`` (or ``PPCA`` for ``algo='ppca'``) on the first array and
  transform every array; the results are tensors on the first array's
  device (the card for an array unless `device` says otherwise)."""
  dev = device_of(x[0], device=device)
  x_train = _float(x[0], dev)
  if algo == "ppca":
    model = PPCA(n_components=n_components, random_state=random_state,
                 device=dev, **kwargs).fit(x_train)
  else:
    model = PCA(n_components=n_components, random_state=random_state,
                device=dev, **kwargs).fit(x_train)
  outs = tuple(model.transform(_float(a, dev)) for a in x)
  outs = outs[0] if len(outs) == 1 else outs
  return (outs, model) if return_model else outs


class PPCA:
  """Probabilistic PCA by EM (Tipping and Bishop), in float32 on the
  input's device: the E- and M-steps of the JAX package's ``em_step``,
  from ``RandomState(random_state).randn(d, q)·0.1``, until σ² moves by
  less than ``tol`` times the centred data's variance (the σ² stop can
  fall one iteration apart from JAX's where the move lies at the limit's
  rounding)."""

  def __init__(self, n_components: int = 2, n_iter: int = 50,
               tol: float = 1e-4, random_state: int = 1,
               verbose: bool = False, device=None):
    self.n_components = int(n_components)
    self.n_iter = int(n_iter)
    self.tol = float(tol)
    self.random_state = int(random_state)
    self.verbose = verbose
    self.device = device
    self.W: Optional[torch.Tensor] = None
    self.sigma2: float = 1.0
    self.mean: Optional[torch.Tensor] = None

  def fit(self, X, y=None) -> "PPCA":
    X = as_tensor(X, device_of(X, device=self.device), torch.float32)
    n, d = X.shape
    q = self.n_components
    self.mean = X.mean(0)
    Xc = X - self.mean
    rng = np.random.RandomState(self.random_state)
    W = torch.from_numpy(rng.randn(d, q).astype("f") * 0.1).to(X.device)
    sigma2 = torch.tensor(1.0, dtype=torch.float32, device=X.device)
    S_diag_mean = float(torch.var(Xc, correction=0))
    eye = torch.eye(q, dtype=torch.float32, device=X.device)
    sum_sq = torch.sum(Xc * Xc)
    prev = np.inf
    with ieee_fp32_matmuls():
      for it in range(self.n_iter):
        Minv = torch.linalg.inv(W.T @ W + sigma2 * eye)
        Ez = Xc @ W @ Minv
        sumEzz = n * sigma2 * Minv + Ez.T @ Ez
        W = torch.linalg.solve(sumEzz.T, Ez.T @ Xc).T
        s2 = (sum_sq - 2 * torch.sum((Ez @ W.T) * Xc) +
              torch.trace(sumEzz @ (W.T @ W))) / (n * d)
        sigma2 = torch.clamp(s2, min=1e-8)
        s = float(sigma2)
        if self.verbose and it % 10 == 0:
          print(f"[PPCA] iter={it} sigma2={s:.5f}")
        if abs(prev - s) < self.tol * S_diag_mean:
          break
        prev = s
    self.n_iter_ = it + 1
    self.W = W
    self.sigma2 = float(sigma2)
    return self

  def transform(self, X) -> torch.Tensor:
    """Posterior-mean latents, float64 (float32 (X − mean)·W, then the
    float64 inverse of Wᵀ W + σ² I)."""
    X = as_tensor(X, self.W.device, torch.float32) - self.mean
    M = (self.W.T @ self.W).to(F64) + self.sigma2 * torch.eye(
        self.n_components, dtype=F64, device=self.W.device)
    with ieee_fp32_matmuls():
      return (X @ self.W).to(F64) @ torch.linalg.inv(M)

  def fit_transform(self, X, y=None) -> torch.Tensor:
    return self.fit(X).transform(X)

  def inverse_transform(self, Z) -> torch.Tensor:
    Z = as_tensor(Z, self.W.device)
    with ieee_fp32_matmuls():
      return Z @ self.W.T.to(Z.dtype) + self.mean.to(Z.dtype)


class SupervisedPPCA(PPCA):
  """PPCA, then ``LinearDiscriminantAnalysis(n_components=min(q, K − 1))``
  fitted on its latents when labels are given; ``transform`` applies
  both."""

  def __init__(self, n_components: int = 2, **kwargs):
    super().__init__(n_components=n_components, **kwargs)
    self._rotation = None

  def fit(self, X, y=None) -> "SupervisedPPCA":
    super().fit(X)
    if y is not None:
      Z = super().transform(X)
      y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
      n_cls = len(np.unique(y))
      self._rotation = LinearDiscriminantAnalysis(
          n_components=min(self.n_components, n_cls - 1)).fit(Z, y.ravel())
    return self

  def transform(self, X) -> torch.Tensor:
    Z = super().transform(X)
    return Z if self._rotation is None else self._rotation.transform(Z)


class MiniBatchPCA:
  """``IncrementalPCA(n_components, batch_size)`` behind the JAX package's
  thin wrapper."""

  def __init__(self, n_components: Optional[int] = None,
               batch_size: Optional[int] = None, device=None):
    self._model = IncrementalPCA(n_components=n_components,
                                 batch_size=batch_size, device=device)

  def partial_fit(self, X) -> "MiniBatchPCA":
    self._model.partial_fit(X)
    return self

  def fit(self, X) -> "MiniBatchPCA":
    self._model.fit(X)
    return self

  def transform(self, X) -> torch.Tensor:
    return self._model.transform(X)

  @property
  def components_(self) -> torch.Tensor:
    return self._model.components_


class RandomizedPCA:
  """PCA by randomized SVD (Halko et al. 2009) as the JAX package computes
  it, in float32: a Gaussian sketch of ``min(2k + 10, d)`` columns, QR
  re-orthonormalisation after each of `iterated_power` power iterations,
  the SVD of the small projected matrix.  The sketch is drawn from
  ``torch.Generator().manual_seed(random_state or 0)`` unless given to
  ``fit`` (JAX draws it from ``jax.random``); no sign convention is
  applied, so components equal JAX's from the same sketch up to the sign
  of each row."""

  def __init__(self, n_components: Optional[int] = None, copy: bool = True,
               iterated_power: int = 2, whiten: bool = False,
               random_state: Optional[int] = None, device=None):
    self.n_components = n_components
    self.copy = bool(copy)
    self.iterated_power = int(iterated_power)
    self.whiten = bool(whiten)
    self.random_state = random_state
    self.device = device

  def sketch_shape(self, n: int, d: int):
    k = min(self.n_components or min(n, d), min(n, d))
    return d, min(2 * k + 10, d)

  def fit(self, X, y=None, sketch=None) -> "RandomizedPCA":
    X = as_tensor(X, device_of(X, device=self.device), torch.float32)
    n, d = X.shape
    k = min(self.n_components or min(n, d), min(n, d))
    shape = self.sketch_shape(n, d)
    if sketch is None:
      gen = torch.Generator().manual_seed(
          self.random_state if self.random_state is not None else 0)
      sketch = torch.randn(shape, generator=gen)
    Q = as_tensor(sketch, X.device, torch.float32)
    if tuple(Q.shape) != shape:
      raise ValueError(f"the sketch is {tuple(Q.shape)}, not {shape}")
    mean = X.mean(0)
    Xc = X - mean
    with ieee_fp32_matmuls():
      Y = torch.linalg.qr(Xc @ Q)[0]
      for _ in range(self.iterated_power):
        Z = torch.linalg.qr(Xc.T @ Y)[0]
        Y = torch.linalg.qr(Xc @ Z)[0]
      _, s, Vt = torch.linalg.svd(Y.T @ Xc, full_matrices=False)
    self.mean_ = mean
    self.singular_values_ = s[:k]
    self.components_ = Vt[:k].contiguous()
    var = self.singular_values_ ** 2 / max(n - 1, 1)
    total_var = float(torch.var(Xc, dim=0, correction=1).sum())
    self.explained_variance_ = var
    self.explained_variance_ratio_ = var / max(total_var, 1e-12)
    self.n_samples_ = n
    return self

  def transform(self, X) -> torch.Tensor:
    X = as_tensor(X, self.mean_.device, torch.float32) - self.mean_
    with ieee_fp32_matmuls():
      out = X @ self.components_.T
    if self.whiten:
      # scikit-learn's convention: whitened = U·√(n − 1)
      out = out.to(F64) * math.sqrt(max(self.n_samples_ - 1, 1)) / \
          torch.clamp(self.singular_values_, min=1e-12).to(F64)
    return out

  def fit_transform(self, X, y=None, sketch=None) -> torch.Tensor:
    return self.fit(X, sketch=sketch).transform(X)

  def inverse_transform(self, X) -> torch.Tensor:
    X = as_tensor(X, self.mean_.device, torch.float32)
    if self.whiten:
      X = X * self.singular_values_ / math.sqrt(max(self.n_samples_ - 1, 1))
    with ieee_fp32_matmuls():
      return X @ self.components_ + self.mean_
