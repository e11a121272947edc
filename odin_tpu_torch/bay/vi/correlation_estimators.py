"""The k-NN mutual information and the Lasso of the port, on the device of
their inputs: scikit-learn 1.9's ``mutual_info_classif``,
``mutual_info_regression`` and ``Lasso``, carried in torch (the card's
machine has no scikit-learn).

The mutual information follows ``sklearn/feature_selection/_mutual_info.py``:
continuous features scaled by their population std (``scale(with_mean=
False)``) in float64, then jittered by ``1e-10·max(1, mean|x|)`` times
standard normals drawn from ``RandomState(random_state)`` in scikit-learn's
order (the features' (n, d) draw, then the target's), on the host with
numpy so that the inputs are scikit-learn's to the bit; ``_compute_mi_cd``
for a discrete target and ``_compute_mi_cc`` for a continuous one.  In one
dimension a point's neighbours lie beside it in sorted order, so a label's
k-th nearest distance comes from the k sorted neighbours on each side, and
the count of points within a radius from two binary searches over the
sorted values on the exact test ``|c − x| ≤ r`` (what the KD-tree tests);
a label small enough that scikit-learn searches it by brute force
(k >= count // 2) has its distances formed as that search forms them;
the 2-D Chebyshev neighbours of ``_compute_mi_cc`` come from chunked
distances.  All labels, and all rows, at once.

``Lasso`` follows ``sklearn/linear_model/_cd_fast.pyx``'s
``enet_coordinate_descent``, one target at a time: the data centred
(``fit_intercept``), the penalty ``alpha·n``, cyclic coordinate updates,
the stop on the largest update against the largest coefficient, then on
the duality gap against ``tol·‖y‖²``, and the gap-safe screening that
fixes coefficients at 0.  Every quantity it needs of the rows is in the
float64 Gram matrix ``XᵀX`` and ``Xᵀy``, made once on the device; the
sweeps run on those (d × d) numbers on the host.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from odin_tpu_torch.bay.vi.estimators import (as_tensor, device_of,
                                              mutual_info_matrix)
from odin_tpu_torch.ml.neighbors import row_chunks, sqrt_rn

__all__ = ["mutual_info_classif", "mutual_info_regression", "Lasso",
           "count_within"]

_TINY_SCALE = 10 * np.finfo(np.float64).eps  # _handle_zeros_in_scale


def _rng(random_state) -> np.random.RandomState:
  if isinstance(random_state, np.random.RandomState):
    return random_state
  return np.random.RandomState(random_state)


def _first_false(pred, n: int, shape, device) -> torch.Tensor:
  """The first index in [0, n] at which `pred(index)` turns false, for a
  predicate true on a prefix of the indices (one binary search per
  element of `shape`)."""
  lo = torch.zeros(shape, dtype=torch.int64, device=device)
  hi = torch.full(shape, n, dtype=torch.int64, device=device)
  for _ in range((n + 1).bit_length()):
    active = lo < hi
    mid = (lo + hi) // 2
    ok = pred(torch.clamp(mid, max=max(n - 1, 0)))
    lo = torch.where(active & ok, mid + 1, lo)
    hi = torch.where(active & ~ok, mid, hi)
  return lo


def count_within(sorted_values: torch.Tensor, x: torch.Tensor,
                 radius: torch.Tensor) -> torch.Tensor:
  """For each x, the number of sorted values c with |c − x| ≤ radius (the
  difference rounded as computed, as the KD-tree tests it)."""
  n = sorted_values.numel()
  right = _first_false(lambda j: sorted_values[j] - x <= radius, n, x.shape,
                       x.device)
  left = _first_false(lambda j: x - sorted_values[j] > radius, n, x.shape,
                      x.device)
  return right - left


def _kth_nearest_1d(values: torch.Tensor, labels: torch.Tensor, k: int):
  """Each point's distance to its k_g-th nearest other point of its own
  label (k_g = min(k, count − 1)), the k_g, and the label's count.  A
  label's neighbours are searched as scikit-learn searches them: by its
  KD-tree (exact |x − y|), or, where k_g >= count // 2, by brute force
  (the squared distance ``(x² + (−2·x·y)) + y²``, its square root)."""
  n = values.numel()
  dev = values.device
  order = torch.argsort(values, stable=True)
  order = order[torch.argsort(labels[order], stable=True)]
  v, lab = values[order], labels[order]
  _, inv, counts = torch.unique(lab, return_inverse=True, return_counts=True)
  starts = torch.cumsum(counts, 0) - counts
  pos = torch.arange(n, device=dev)
  # a brute-force label has at most 2k + 1 points: all within 2k places
  offsets = torch.cat([torch.arange(-2 * k, 0, device=dev),
                       torch.arange(1, 2 * k + 1, device=dev)])
  nb = pos[:, None] + offsets[None]
  inside = (nb >= starts[inv][:, None]) & (nb < (starts + counts)[inv][:, None])
  other = v[nb.clamp(0, n - 1)]
  count = counts[inv]
  k_g = torch.clamp(count - 1, max=k)
  brute = (k_g >= count // 2)[:, None]
  sq = v * v
  key = torch.where(brute, (sq[:, None] + (-2.0 * (v[:, None] * other))) +
                    sq[nb.clamp(0, n - 1)], torch.abs(other - v[:, None]))
  key = torch.where(inside, key, torch.full_like(key, math.inf))
  kth = torch.sort(key, dim=1).values.gather(
      1, torch.clamp(k_g - 1, min=0)[:, None])[:, 0]
  kth = torch.where(brute[:, 0], sqrt_rn(torch.clamp(kth, min=0.0)), kth)
  out = [torch.empty_like(t) for t in (kth, k_g, count)]
  for o, t in zip(out, (kth, k_g, count)):
    o[order] = t
  return out


def _digamma_mean(t: torch.Tensor) -> torch.Tensor:
  return torch.digamma(t.to(torch.float64)).mean()


def _mi_cd(c: torch.Tensor, d: torch.Tensor, n_neighbors: int) -> float:
  """``_compute_mi_cd``: a continuous column c against discrete labels d."""
  radius, k_all, label_counts = _kth_nearest_1d(c, d, n_neighbors)
  keep = label_counts > 1
  c, radius = c[keep], radius[keep]
  k_all, label_counts = k_all[keep], label_counts[keep]
  radius = torch.nextafter(radius, torch.zeros_like(radius))
  m_all = count_within(torch.sort(c).values, c, radius)
  n = int(keep.sum())
  mi = (torch.digamma(torch.tensor(float(n), dtype=torch.float64)) +
        _digamma_mean(k_all).cpu() - _digamma_mean(label_counts).cpu() -
        _digamma_mean(m_all).cpu())
  return max(0.0, float(mi))


def _mi_cc(x: torch.Tensor, y: torch.Tensor, n_neighbors: int) -> float:
  """``_compute_mi_cc``: two continuous columns (Chebyshev neighbours in
  the joint space)."""
  n = x.numel()
  kth = []
  for rows in row_chunks(n, n, 3):
    d = torch.maximum(torch.abs(x[rows, None] - x[None]),
                      torch.abs(y[rows, None] - y[None]))
    r = torch.arange(rows.start, rows.stop, device=x.device)
    d[r - rows.start, r] = -1.0  # the point itself, dropped once
    kth.append(torch.topk(d, n_neighbors + 1, dim=1,
                          largest=False).values[:, -1])
  radius = torch.cat(kth)
  radius = torch.nextafter(radius, torch.zeros_like(radius))
  nx = count_within(torch.sort(x).values, x, radius) - 1
  ny = count_within(torch.sort(y).values, y, radius) - 1
  mi = (torch.digamma(torch.tensor(float(n), dtype=torch.float64)) +
        torch.digamma(torch.tensor(float(n_neighbors), dtype=torch.float64)) -
        _digamma_mean(nx + 1).cpu() - _digamma_mean(ny + 1).cpu())
  return max(0.0, float(mi))


def _scale_jitter(a: torch.Tensor, rng: np.random.RandomState,
                  size) -> torch.Tensor:
  """``scale(with_mean=False)`` then ``+= 1e-10·max(1, mean|a|)·N(0, 1)``
  along the rows, in float64 with numpy on the host, bit for bit as
  scikit-learn computes it: the brute-force distances of small labels
  cancel, so a one-ulp change of an input can move a neighbour count.  A
  (n, d) `a` keeps a column whose std is below ``10·eps`` unscaled, a (n,)
  one only a std of 0 (``_handle_zeros_in_scale`` for an array and for a
  scalar).  O(n·d) work; the neighbour searches stay on the device."""
  x = a.detach().cpu().numpy().astype(np.float64)
  if x.ndim == 2:
    # scikit-learn scales the copy ``X[:, continuous_mask]``, whose memory
    # order sets numpy's summation order
    every = np.ones(x.shape[1], dtype=bool)
    sub = x[:, every]
    std = np.nanstd(sub, axis=0)
    std[std < _TINY_SCALE] = 1.0
    sub /= std
    x[:, every] = sub
    means = np.maximum(1, np.mean(np.abs(x[:, every]), axis=0))
    x[:, every] += 1e-10 * means * rng.standard_normal(size=size)
  else:
    std = np.nanstd(x)
    x /= 1.0 if std == 0.0 else std
    x += 1e-10 * np.maximum(1, np.mean(np.abs(x))) * rng.standard_normal(
        size=size)
  return torch.from_numpy(x).to(a.device)


def _estimate_mi(X, y, discrete_features: bool, discrete_target: bool,
                 n_neighbors: int, random_state, device) -> torch.Tensor:
  dev = device_of(X, y, device=device)
  X = as_tensor(X, dev)
  y = as_tensor(y, dev).reshape(-1)
  if X.ndim == 1:
    X = X[:, None]
  n, d = X.shape
  rng = _rng(random_state)
  if not discrete_features:
    X = _scale_jitter(X.to(torch.float64), rng, (n, d))
  if not discrete_target:
    y = _scale_jitter(y.to(torch.float64), rng, n)
  out = []
  for j in range(d):
    x = X[:, j]
    if discrete_features and discrete_target:
      out.append(float(mutual_info_matrix(x[:, None], y[:, None])[0, 0]))
    elif discrete_features:
      out.append(_mi_cd(y, x, n_neighbors))
    elif discrete_target:
      out.append(_mi_cd(x, y, n_neighbors))
    else:
      out.append(_mi_cc(x, y, n_neighbors))
  return torch.tensor(out, dtype=torch.float64, device=dev)


def mutual_info_classif(X, y, *, discrete_features: bool = False,
                        n_neighbors: int = 3, random_state=None,
                        device=None) -> torch.Tensor:
  """(d,) mutual information (nats, float64) between each feature of X and
  the discrete target y."""
  return _estimate_mi(X, y, bool(discrete_features), True, n_neighbors,
                      random_state, device)


def mutual_info_regression(X, y, *, discrete_features: bool = False,
                           n_neighbors: int = 3, random_state=None,
                           device=None) -> torch.Tensor:
  """(d,) mutual information (nats, float64) between each feature of X and
  the continuous target y."""
  return _estimate_mi(X, y, bool(discrete_features), False, n_neighbors,
                      random_state, device)


# ---------------------------------------------------------------------------
# Lasso
# ---------------------------------------------------------------------------
def _gap(w, alpha, G, Xy, yy):
  """(gap, XᵀR, ‖XᵀR‖∞) of formulation A of ``gap_enet`` (beta 0)."""
  Gw = G @ w
  r_norm2 = yy - 2.0 * (w @ Xy) + w @ Gw
  ry = yy - w @ Xy
  xta = Xy - Gw
  dual_norm = float(np.max(np.abs(xta)))
  primal = 0.5 * r_norm2 + alpha * float(np.sum(np.abs(w)))
  scale = alpha / dual_norm if dual_norm > alpha else 1.0
  dual = -0.5 * scale ** 2 * r_norm2 + scale * ry
  return primal - dual, xta, dual_norm


def _screen(w, excluded, xta, dual_norm, gap, alpha, norm2):
  """Gap-safe screening: the active coordinates; the others fixed at 0."""
  active = []
  for j in range(len(w)):
    if excluded[j]:
      continue
    theta = xta[j] / max(alpha, dual_norm)
    if (1 - abs(theta)) / math.sqrt(norm2[j]) <= math.sqrt(2 * gap) / alpha:
      active.append(j)
    else:
      w[j] = 0.0
      excluded[j] = True
  return active


def _coordinate_descent(G, Xy, yy, alpha, max_iter, tol):
  """One target's ``enet_coordinate_descent`` (l1 only, cyclic, screening)
  on the Gram matrix: (w, gap, n_iter)."""
  d = len(Xy)
  w = np.zeros(d)
  norm2 = np.diag(G).copy()
  tol_gap = tol * yy
  gap, xta, dual_norm = _gap(w, alpha, G, Xy, yy)
  if gap <= tol_gap:
    return w, gap, 0
  excluded = norm2 == 0
  active = _screen(w, excluded, xta, dual_norm, gap, alpha, norm2)
  for n_iter in range(max_iter):
    w_max = d_w_max = 0.0
    for j in active:
      w_j = w[j]
      tmp = (Xy[j] - G[j] @ w) + w_j * norm2[j]
      w[j] = math.copysign(max(abs(tmp) - alpha, 0.0), tmp) / norm2[j]
      d_w_max = max(d_w_max, abs(w[j] - w_j))
      w_max = max(w_max, abs(w[j]))
    if w_max == 0.0 or d_w_max / w_max <= tol or n_iter == max_iter - 1:
      gap, xta, dual_norm = _gap(w, alpha, G, Xy, yy)
      if gap <= tol_gap:
        break
      active = _screen(w, excluded, xta, dual_norm, gap, alpha, norm2)
  return w, gap, n_iter + 1


class Lasso:
  """scikit-learn's ``Lasso(alpha)``: min ½n⁻¹‖y − Xw − b‖² + alpha‖w‖₁ by
  cyclic coordinate descent, one target of a 2-D y at a time."""

  def __init__(self, alpha: float = 1.0, *, fit_intercept: bool = True,
               max_iter: int = 1000, tol: float = 1e-4,
               random_state=None, selection: str = "cyclic", device=None):
    if selection != "cyclic":
      raise ValueError("only selection='cyclic' is ported")
    self.alpha = float(alpha)
    self.fit_intercept = bool(fit_intercept)
    self.max_iter = int(max_iter)
    self.tol = float(tol)
    self.random_state = random_state
    self.device = device

  def fit(self, X, y) -> "Lasso":
    dev = device_of(X, y, device=self.device)
    X = as_tensor(X, dev).to(torch.float64)
    y = as_tensor(y, dev).to(torch.float64)
    one_target = y.ndim == 1
    Y = y[:, None] if one_target else y
    n = X.shape[0]
    if self.fit_intercept:
      x_offset, y_offset = X.mean(0), Y.mean(0)
      X, Y = X - x_offset, Y - y_offset
    else:
      x_offset = torch.zeros(X.shape[1], dtype=torch.float64, device=dev)
      y_offset = torch.zeros(Y.shape[1], dtype=torch.float64, device=dev)
    G = (X.T @ X).cpu().numpy()
    XY = (X.T @ Y).cpu().numpy()
    YY = (Y * Y).sum(0).cpu().numpy()
    coefs, gaps, iters = [], [], []
    for t in range(Y.shape[1]):
      w, gap, n_iter = _coordinate_descent(G, XY[:, t], float(YY[t]),
                                           self.alpha * n, self.max_iter,
                                           self.tol)
      coefs.append(w)
      gaps.append(gap)
      iters.append(n_iter)
    coef = torch.as_tensor(np.stack(coefs)).to(dev)
    intercept = y_offset - coef @ x_offset
    if one_target:
      coef, intercept = coef[0], intercept[0]
    self.coef_, self.intercept_ = coef, intercept
    self.dual_gap_ = gaps[0] if one_target else np.asarray(gaps)
    self.n_iter_ = iters[0] if one_target else iters
    return self

  def predict(self, X) -> torch.Tensor:
    X = as_tensor(X, self.coef_.device).to(torch.float64)
    return X @ self.coef_.T + self.intercept_
