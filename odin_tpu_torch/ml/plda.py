"""PLDA of the port: probabilistic linear discriminant analysis (PyTorch port
of ``odin_tpu/ml/plda.py``).

Simplified PLDA, x = m + Φ y + ε with y ~ N(0, I) and ε ~ N(0, Σ), trained
by EM over class-grouped vectors (classes with equal counts share their
posterior precision), after centering, WCCN and unit length
(``VectorNormalizer``).  Everything runs in float64 on `device`; ``Phi`` is
drawn from ``np.random.RandomState(random_state)`` as the JAX package draws
it, and the params and scores stay on the device as tensors.

``fit_maximum_likelihood`` is the JAX package's PCA initialisation with
scikit-learn's ``PCA`` carried as a full SVD in torch.  Its components take
scikit-learn's sign convention (``svd_flip`` on the components: the entry of
largest magnitude in each is positive).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from odin_tpu_torch.device import resolve_device
from odin_tpu_torch.ml.gmm_tmat import _numpy, _on
from odin_tpu_torch.ml.scoring import F64, VectorNormalizer, _class_index

__all__ = ["PLDA"]


class PLDA:

  def __init__(self,
               n_phi: int = 100,
               centering: bool = True,
               wccn: bool = True,
               unit_length: bool = True,
               n_iter: int = 12,
               random_state: int = 1,
               device: Union[str, torch.device] = "cuda"):
    self.n_phi = int(n_phi)
    self.n_iter = int(n_iter)
    self.random_state = int(random_state)
    self.device = resolve_device(device)
    self.normalizer = VectorNormalizer(centering=centering, wccn=wccn,
                                       unit_length=unit_length,
                                       device=self.device)
    self.mean: Optional[torch.Tensor] = None
    self.Phi: Optional[torch.Tensor] = None     # (D, n_phi)
    self.Sigma: Optional[torch.Tensor] = None   # (D, D)
    self._class_latents: Optional[torch.Tensor] = None  # (K, n_phi)
    self._trained_classes: Optional[np.ndarray] = None

  def _eye(self, n: int) -> torch.Tensor:
    return torch.eye(n, dtype=F64, device=self.device)

  def fit_maximum_likelihood(self, X, y=None):
    """PCA initialisation (reference :213): Phi the first `n_phi` principal
    directions scaled by their standard deviations, Sigma isotropic at the
    residual variance plus 1e-3, mean the data mean."""
    X = _on(X, self.device, F64)
    n, D = X.shape
    mean = X.mean(0)
    Xc = X - mean
    _, S, Vt = torch.linalg.svd(Xc, full_matrices=False)
    rows = torch.arange(len(Vt), device=self.device)
    Vt = Vt * torch.sign(Vt[rows, torch.argmax(Vt.abs(), 1)])[:, None]
    comps = Vt[:self.n_phi]
    var = S[:self.n_phi] ** 2 / (n - 1)
    self.Phi = (comps * torch.sqrt(var)[:, None]).T
    resid = Xc - (Xc @ comps.T) @ comps
    self.Sigma = self._eye(D) * (float(resid.var(correction=0)) + 1e-3)
    self.mean = mean

  def fit(self, X, y) -> "PLDA":
    X = self.normalizer.fit(X, y).transform(X)
    self.mean = X.mean(0)
    Xc = X - self.mean
    N, D = X.shape
    classes, y_idx = _class_index(y)
    K = len(classes)
    counts = np.bincount(y_idx).astype(np.float64)  # (K,)
    yi = torch.from_numpy(y_idx).to(self.device)
    class_sums = torch.zeros((K, D), dtype=F64,
                             device=self.device).index_add_(0, yi, Xc)
    rng = np.random.RandomState(self.random_state)
    Phi = torch.from_numpy(rng.randn(D, self.n_phi) * 0.1).to(self.device)
    Sigma = torch.cov(Xc.T) + 1e-6 * self._eye(D)
    I_r = self._eye(self.n_phi)
    # classes with equal counts share their posterior precision
    groups = [(float(n), torch.from_numpy(np.flatnonzero(counts == n)).to(
        self.device)) for n in np.unique(counts)]
    for _ in range(self.n_iter):
      # E-step: the posterior of each class's y, L = I + n Φ'Σ⁻¹Φ
      PtSi = Phi.T @ torch.linalg.inv(Sigma)            # (r, D)
      Ey = torch.zeros((K, self.n_phi), dtype=F64, device=self.device)
      sum_Eyy = torch.zeros((self.n_phi, self.n_phi), dtype=F64,
                            device=self.device)
      Rphi = torch.zeros((self.n_phi, D), dtype=F64, device=self.device)
      for n, rows in groups:
        Li = torch.linalg.inv(I_r + n * (PtSi @ Phi))
        sums = class_sums[rows]
        Eyk = (Li @ (PtSi @ sums.T)).T                  # (k_n, r)
        Ey[rows] = Eyk
        # sum_k n_k E[y y'] = n (k_n Li + sum Eyk Eyk')
        sum_Eyy += n * (len(rows) * Li + Eyk.T @ Eyk)
        Rphi += (n * Eyk.T) @ (sums / n)
      # M-step
      Phi = torch.linalg.solve(sum_Eyy, Rphi).T         # (D, r)
      resid = Xc - Ey[yi] @ Phi.T
      Sigma = (resid.T @ Xc) / N
      Sigma = 0.5 * (Sigma + Sigma.T) + 1e-6 * self._eye(D)
    self.Phi = Phi
    self.Sigma = Sigma
    # per-class latent means for closed-set classification
    self._trained_classes = classes
    PtSi = Phi.T @ torch.linalg.inv(Sigma)
    L = I_r + torch.from_numpy(counts).to(self.device)[:, None, None] * \
        (PtSi @ Phi)
    self._class_latents = torch.linalg.solve(
        L, (class_sums @ PtSi.T)[..., None])[..., 0]
    return self

  # -- verification scoring -----------------------------------------------------
  def _prep(self, X) -> torch.Tensor:
    return self.normalizer.transform(X) - self.mean

  def _covariances(self):
    """(B, W, B + W): between, within and total covariance."""
    B = self.Phi @ self.Phi.T
    return B, self.Sigma, B + self.Sigma

  def score_trials(self, enroll, test) -> torch.Tensor:
    """Log-likelihood ratio same against different speaker of each pair
    (enroll_i, test_i): the two-covariance PLDA llr, from the joint
    Gaussians of the pair under both hypotheses."""
    E, T = self._prep(enroll), self._prep(test)
    B, _, tot = self._covariances()
    zero = torch.zeros_like(B)
    same = torch.cat([torch.cat([tot, B], 1), torch.cat([B, tot], 1)])
    diff = torch.cat([torch.cat([tot, zero], 1), torch.cat([zero, tot], 1)])
    ld_same = torch.linalg.slogdet(same)[1]
    ld_diff = torch.linalg.slogdet(diff)[1]
    XY = torch.cat([E, T], 1)
    q_same = ((XY @ torch.linalg.inv(same)) * XY).sum(1)
    q_diff = ((XY @ torch.linalg.inv(diff)) * XY).sum(1)
    return -0.5 * (q_same - q_diff) - 0.5 * (ld_same - ld_diff)

  def score_matrix(self, enroll, test) -> torch.Tensor:
    """(n_enroll, n_test) llr matrix, in the Schur-complement form of
    ``score_trials`` evaluated pairwise: e'P t + ½e'Q e + ½t'Q t + const."""
    E, T = self._prep(enroll), self._prep(test)
    B, _, tot = self._covariances()
    tot_i = torch.linalg.inv(tot)
    schur = tot - B @ tot_i @ B
    Lambda = torch.linalg.inv(schur)
    Q = tot_i - Lambda
    P = tot_i @ B @ Lambda
    ld_tot = torch.linalg.slogdet(tot)[1]
    ld_schur = torch.linalg.slogdet(schur)[1]
    const = 0.5 * (2 * ld_tot - ld_tot - ld_schur)
    sE = 0.5 * ((E @ Q) * E).sum(1)
    sT = 0.5 * ((T @ Q) * T).sum(1)
    return E @ P @ T.T + sE[:, None] + sT[None, :] + const

  def predict_log_proba(self, X) -> torch.Tensor:
    """Closed-set class log-probabilities (n, K) against the training
    classes (reference :384)."""
    X = self._prep(X)
    means = self._class_latents @ self.Phi.T     # (K, D)
    Si = torch.linalg.inv(self.Sigma)
    ld = torch.linalg.slogdet(self.Sigma)[1]
    diff = X[:, None, :] - means[None, :, :]
    ll = -0.5 * (((diff @ Si) * diff).sum(-1) + ld)
    return torch.log_softmax(ll, dim=1)

  def predict(self, X) -> np.ndarray:
    return self._trained_classes[
        _numpy(torch.argmax(self.predict_log_proba(X), dim=1))]
