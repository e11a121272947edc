"""t-SNE of the port, on the device of its input: scikit-learn 1.9's
``TSNE`` as the JAX package calls it (``method='barnes_hut'``'s sparse P,
``init='pca'``, ``learning_rate='auto'``), carried in torch (the card's
machine has no scikit-learn), and ``trustworthiness``.

- P: each row's k = min(n − 1, ⌊3·perplexity + 1⌋) nearest neighbours from
  chunked float64 distances (``neighbors.kneighbors``), their squared
  distances rounded to float32, then ``_binary_search_perplexity`` on every
  row at once (float64, up to 100 halvings of beta, a row frozen once its
  entropy is within 1e-5 of log(perplexity)), then P + Pᵀ over its sum;
- the embedding starts at the first two principal components (float64
  eigenvectors of the covariance, each signed so its largest entry is
  positive, as ``svd_flip`` does), scaled to a first-column std of 1e-4;
- the gradient is the exact Student-t gradient of KL(P‖Q) (what the
  Barnes-Hut tree's angle-0.5 sums approximate): the attraction over P's
  nonzeros, the repulsion and Q's normaliser over every pair, row chunk by
  row chunk on the device, in the embedding's float32;
- ``_gradient_descent`` step for step: 250 iterations of early
  exaggeration 12 at momentum 0.5, then momentum 0.8 to ``max_iter``, the
  gains +0.2 / ×0.8 floored at 0.01, the KL and the gradient norm checked
  every 50 iterations (the only reads to the host), stopping after
  ``n_iter_without_progress`` checked iterations without a better KL or at
  a gradient norm of 1e-7.

The trajectory is chaotic and scikit-learn's gradient is approximate, so
an embedding is held against scikit-learn's by its KL and its
trustworthiness, not point by point.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from odin_tpu_torch.device import as_tensor, device_of
from odin_tpu_torch.ml.neighbors import kneighbors, row_chunks

__all__ = ["TSNE", "joint_probabilities_nn", "kl_divergence_grad",
           "trustworthiness"]

MACHINE_EPSILON = float(np.finfo(np.double).eps)
FLOAT32_TINY = float(np.finfo(np.float32).tiny)
# _utils.pyx's constants are C floats
EPSILON_DBL = float(np.float32(1e-8))
PERPLEXITY_TOLERANCE = float(np.float32(1e-5))


def _binary_search_perplexity(sqd: torch.Tensor, perplexity: float
                              ) -> torch.Tensor:
  """(n, k) float64 conditional P of each row's neighbours (float32 squared
  distances `sqd`), every row's beta searched at once."""
  n = sqd.shape[0]
  dev = sqd.device
  d = sqd.to(torch.float64)
  desired = math.log(float(np.float32(perplexity)))
  beta = torch.ones(n, dtype=torch.float64, device=dev)
  lo = torch.full_like(beta, -math.inf)
  hi = torch.full_like(beta, math.inf)
  done = torch.zeros(n, dtype=torch.bool, device=dev)
  P = torch.zeros_like(d)
  for step in range(100):
    p = torch.exp(-d * beta[:, None])
    total = p.sum(1)
    total = torch.where(total == 0.0, EPSILON_DBL, total)
    p = p / total[:, None]
    entropy = torch.log(total) + beta * (d * p).sum(1)
    diff = entropy - desired
    P = torch.where(done[:, None], P, p)
    now = ~done & (torch.abs(diff) <= PERPLEXITY_TOLERANCE)
    move = ~done & ~now
    up = move & (diff > 0.0)
    down = move & (diff <= 0.0)
    lo = torch.where(up, beta, lo)
    hi = torch.where(down, beta, hi)
    beta = torch.where(up, torch.where(torch.isinf(hi), beta * 2.0,
                                       (beta + hi) / 2.0), beta)
    beta = torch.where(down, torch.where(torch.isinf(lo), beta / 2.0,
                                         (beta + lo) / 2.0), beta)
    done = done | now
    if step % 10 == 9 and bool(done.all()):
      break
  return P


def joint_probabilities_nn(X: torch.Tensor, perplexity: float
                           ) -> torch.Tensor:
  """The symmetric joint P (a coalesced sparse (n, n) float64 tensor,
  summing to 1) of ``_joint_probabilities_nn`` on each row's nearest
  neighbours."""
  n = X.shape[0]
  k = min(n - 1, int(3.0 * perplexity + 1))
  dist, idx = kneighbors(X, X, k, exclude_self=True)
  # the CSR graph's rows in column order, as ``sort_indices`` leaves them
  idx, order = torch.sort(idx, dim=1)
  sqd = torch.gather(dist, 1, order) ** 2
  cond = _binary_search_perplexity(sqd.to(torch.float32), perplexity)
  rows = torch.arange(n, device=X.device).repeat_interleave(k)
  cols = idx.reshape(-1)
  P = torch.sparse_coo_tensor(torch.stack([torch.cat([rows, cols]),
                                           torch.cat([cols, rows])]),
                              torch.cat([cond.reshape(-1)] * 2), (n, n),
                              check_invariants=False)
  P = P.coalesce()
  total = max(float(P.values().sum()), MACHINE_EPSILON)
  return torch.sparse_coo_tensor(P.indices(), P.values() / total, (n, n),
                                 check_invariants=False).coalesce()


def kl_divergence_grad(Y: torch.Tensor, P: torch.Tensor,
                       compute_error: bool = True, dof: float = 1.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(KL(P‖Q) as a float64 tensor, its gradient (n, c) in Y's dtype) of
  an embedding Y under the Student-t kernel with `dof` degrees of freedom:
  the exact sums of ``_kl_divergence``, P sparse."""
  n = Y.shape[0]
  idx, vals = P.indices(), P.values().to(Y.dtype)
  i, j = idx[0], idx[1]
  exponent = (dof + 1.0) / 2.0
  diff = Y[i] - Y[j]
  q_un = (dof / (dof + (diff * diff).sum(1))) ** exponent
  attract = torch.zeros_like(Y).index_add_(0, i, (vals * q_un)[:, None] * diff)
  repel = torch.zeros_like(Y)
  z = torch.zeros((), dtype=torch.float64, device=Y.device)
  for rows in row_chunks(n, n, 2):
    d2 = None
    for c in range(Y.shape[1]):
      dc = Y[rows, c, None] - Y[None, :, c]
      d2 = dc * dc if d2 is None else d2 + dc * dc
    w = dof / (dof + d2)
    if exponent != 1.0:
      w = w ** exponent
    r = torch.arange(rows.start, rows.stop, device=Y.device)
    w[r - rows.start, r] = 0.0
    z = z + w.sum(dtype=torch.float64)
    w2 = w * w
    repel[rows] = Y[rows] * w2.sum(1)[:, None] - w2 @ Y
  zf = z.to(Y.dtype)
  c = 2.0 * (dof + 1.0) / dof
  grad = c * (attract - repel / zf)
  kl = torch.full((), math.nan, dtype=torch.float64, device=Y.device)
  if compute_error:
    p64 = P.values()
    q = q_un.to(torch.float64) / z
    kl = torch.sum(p64 * torch.log(torch.clamp(p64, min=FLOAT32_TINY) /
                                   torch.clamp(q, min=FLOAT32_TINY)))
  return kl, grad


def _pca_init(X: torch.Tensor, n_components: int) -> torch.Tensor:
  X64 = X.to(torch.float64)
  Xc = X64 - X64.mean(0)
  cov = Xc.T @ Xc / max(1, X.shape[0] - 1)
  _, vecs = torch.linalg.eigh(cov)
  comps = vecs[:, torch.arange(vecs.shape[1] - 1, -1, -1)].T[:n_components]
  big = torch.argmax(torch.abs(comps), dim=1)
  comps = comps * torch.sign(comps.gather(1, big[:, None]))
  Y = (Xc @ comps.T).to(torch.float32)
  return Y / torch.std(Y[:, 0], correction=0) * 1e-4


class TSNE:
  """scikit-learn's ``TSNE`` (``method='barnes_hut'``'s P with the exact
  gradient, ``init='pca'``)."""

  EXPLORATION_MAX_ITER = 250
  N_ITER_CHECK = 50

  def __init__(self, n_components: int = 2, *, perplexity: float = 30.0,
               early_exaggeration: float = 12.0, learning_rate="auto",
               max_iter: int = 1000, n_iter_without_progress: int = 300,
               min_grad_norm: float = 1e-7, init: str = "pca",
               random_state=None, device=None, **kwargs):
    if init != "pca" or kwargs.get("metric", "euclidean") != "euclidean":
      raise ValueError("only init='pca' with the euclidean metric is ported")
    self.n_components = int(n_components)
    self.perplexity = float(perplexity)
    self.early_exaggeration = float(early_exaggeration)
    self.learning_rate = learning_rate
    self.max_iter = int(max_iter)
    self.n_iter_without_progress = int(n_iter_without_progress)
    self.min_grad_norm = float(min_grad_norm)
    self.random_state = random_state
    self.device = device

  def _descend(self, Y, P, it, max_iter, momentum, patience):
    update = torch.zeros_like(Y)
    gains = torch.ones_like(Y)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
      check = (i + 1) % self.N_ITER_CHECK == 0
      kl, grad = kl_divergence_grad(Y, P, check or i == max_iter - 1)
      inc = update * grad < 0.0
      gains = torch.clamp(torch.where(inc, gains + 0.2, gains * 0.8),
                          min=0.01)
      grad = grad * gains
      update = momentum * update - self.learning_rate_ * grad
      Y = Y + update
      if check or i == max_iter - 1:
        error = float(kl)
      if check:
        grad_norm = float(torch.linalg.vector_norm(grad))
        if error < best_error:
          best_error, best_iter = error, i
        elif i - best_iter > patience:
          break
        if grad_norm <= self.min_grad_norm:
          break
    return Y, error, i

  def fit_transform(self, X) -> torch.Tensor:
    X = as_tensor(X, device_of(X, device=self.device))
    if not X.is_floating_point():
      X = X.to(torch.float64)
    n = X.shape[0]
    if self.perplexity >= n:
      raise ValueError(f"perplexity ({self.perplexity}) must be less than "
                       f"n_samples ({n})")
    self.learning_rate_ = (max(n / self.early_exaggeration / 4, 50.0)
                           if self.learning_rate == "auto"
                           else float(self.learning_rate))
    P = joint_probabilities_nn(X, self.perplexity)
    Y = _pca_init(X, self.n_components)
    exaggerated = torch.sparse_coo_tensor(
        P.indices(), P.values() * self.early_exaggeration, P.shape,
        check_invariants=False).coalesce()
    Y, kl, it = self._descend(Y, exaggerated, 0, self.EXPLORATION_MAX_ITER,
                              0.5, self.EXPLORATION_MAX_ITER)
    if it < self.EXPLORATION_MAX_ITER or self.max_iter > \
        self.EXPLORATION_MAX_ITER:
      Y, kl, it = self._descend(Y, P, it + 1, self.max_iter, 0.8,
                                self.n_iter_without_progress)
    self.n_iter_ = it
    self.kl_divergence_ = kl
    self.embedding_ = Y
    return Y

  def fit(self, X, y=None) -> "TSNE":
    self.fit_transform(X)
    return self


def trustworthiness(X, X_embedded, n_neighbors: int = 5) -> float:
  """scikit-learn's ``trustworthiness``: how far each point's nearest
  neighbours in the embedding rank among its neighbours in X (euclidean,
  X's distances in scikit-learn's float32 form for float32 X)."""
  dev = device_of(X, X_embedded)
  X = as_tensor(X, dev)
  Y = as_tensor(X_embedded, dev)
  n = X.shape[0]
  k = int(n_neighbors)
  if k >= n / 2:
    raise ValueError(f"n_neighbors ({k}) should be less than n_samples / 2 "
                     f"({n / 2})")
  _, nbrs = kneighbors(Y, Y, k, exclude_self=True)
  X64 = X.to(torch.float64)
  x_sq = (X64 * X64).sum(1)
  dtype = X.dtype if X.is_floating_point() else torch.float64
  total = 0
  for rows in row_chunks(n, n, 3):
    d2 = (-2.0 * (X64[rows] @ X64.T) + x_sq[rows, None]) + x_sq[None]
    d = torch.sqrt(torch.clamp(d2.to(dtype), min=0.0))
    r = torch.arange(rows.start, rows.stop, device=dev)
    d[r - rows.start, r] = math.inf
    dij = d.gather(1, nbrs[rows])
    # the rank (from 1) of each embedded neighbour among X's neighbours
    rank = torch.stack([(d < dij[:, c, None]).sum(1) + 1
                        for c in range(k)], 1)
    excess = rank - k
    total += int(excess[excess > 0].sum())
  return 1.0 - total * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))
