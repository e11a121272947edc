"""The scikit-learn estimators that the disentanglement scores fit, carried
in torch so that they run on the device of their inputs.

The JAX package fits them with scikit-learn on the host; the port has no
scikit-learn (the card's machine has none), so each follows scikit-learn
1.9's own code step for step where that decides the result:

- ``train_test_split`` and ``stratified_split``: ``ShuffleSplit`` and
  ``StratifiedShuffleSplit`` (with ``_approximate_mode``) on a numpy
  ``RandomState``, so the same rows are drawn;
- ``StandardScaler``: population std in float64, a constant feature's scale
  set to 1;
- ``mutual_info_score`` / ``mutual_info_matrix``: contingency tables as one
  ``bincount``, in float64, in nats;
- ``LogisticRegression(C)``: multinomial for more than two classes, an L2
  penalty on the coefficients only, solved in float64 by Newton's method
  with a backtracking line search (the minimiser is unique in the
  coefficients, so only predictions near a tie can differ from lbfgs);
- ``LinearSVC(C, class_weight)``: liblinear's primal L2-loss SVM, one
  against the rest, the intercept a penalised constant feature of 1 and,
  as liblinear weighs them, the class weight
  on the positive class of each problem only; all problems of a fit are
  solved at once by one batched generalised-Newton iteration
  (``fit_l2_svc``);
- ``GradientBoostingClassifier``: log-loss boosting of depth-limited
  regression trees on float32 features, the log prior as the first raw
  prediction, scikit-learn's Newton leaf values and its impurity-based
  ``feature_importances_``.  The trees of a stage grow together, level by
  level: each feature is presorted once, and one split search per level
  covers every node, feature and tree, from cumulative sums of the
  residuals over the presorted order and an argmax.  A fit is the same
  bits on every device: its sums are exact or run in a fixed order and its
  softmax is built from IEEE-rounded arithmetic (``_pairwise_sum``,
  ``_exp_nonpositive``), since one last-bit difference in a residual can
  turn a split and every stage after it.

Every reduction that scikit-learn makes in float64 is made in float64
here (the criterion, the Newton solves, the contingency tables), so TF32
never touches them.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from odin_tpu_torch.device import as_tensor, device_of

__all__ = [
    "as_tensor", "device_of", "train_test_split", "stratified_split", "StandardScaler", "mutual_info_score",
    "mutual_info_matrix", "LogisticRegression", "LinearSVC", "fit_l2_svc",
    "GradientBoostingClassifier", "accuracy",
]

# scikit-learn's constants: the splitter's tie threshold on feature values
# (``tree/_partitioner.pxd``) and the impurity floor of its tree growth
# (``tree/_tree.pyx``, ``np.finfo('double').eps``)
FEATURE_THRESHOLD = 1e-7
EPSILON = float(np.finfo(np.float64).eps)


def accuracy(pred: torch.Tensor, y: torch.Tensor) -> float:
  """Share of equal entries, as a float."""
  return float((pred == y).to(torch.float64).mean())


# ---------------------------------------------------------------------------
# splits
# ---------------------------------------------------------------------------
def _split_sizes(n: int, test_size: float) -> Tuple[int, int]:
  """(n_train, n_test) of ``_validate_shuffle_split`` for a float
  test_size and no train_size."""
  if not 0.0 < test_size < 1.0:
    raise ValueError(f"test_size must lie in (0, 1), got {test_size}")
  n_test = math.ceil(test_size * n)
  n_train = n - n_test
  if n_train <= 0:
    raise ValueError(f"test_size={test_size} leaves no training row of {n}")
  return n_train, n_test


def _train_test_indices(n: int, test_size: float = 0.25,
                       random_state: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray]:
  """(train rows, test rows) of ``ShuffleSplit``: one
  ``RandomState(random_state).permutation(n)``, the test rows first."""
  n_train, n_test = _split_sizes(n, test_size)
  perm = np.random.RandomState(random_state).permutation(n)
  return perm[n_test:n_test + n_train], perm[:n_test]


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
  """scikit-learn's ``utils.extmath._approximate_mode``."""
  continuous = class_counts / class_counts.sum() * n_draws
  floored = np.floor(continuous)
  need_to_add = int(n_draws - floored.sum())
  if need_to_add > 0:
    remainder = continuous - floored
    values = np.sort(np.unique(remainder))[::-1]
    for value in values:
      (inds,) = np.where(remainder == value)
      add_now = min(len(inds), need_to_add)
      inds = rng.choice(inds, size=add_now, replace=False)
      floored[inds] += 1
      need_to_add -= add_now
      if need_to_add == 0:
        break
  return floored.astype(int)


def stratified_split(y, test_size: float = 0.25, random_state: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
  """(train rows, test rows) of ``StratifiedShuffleSplit`` (one split) on
  labels `y`, the draws of scikit-learn's ``_iter_indices``."""
  y = np.asarray(y.cpu() if isinstance(y, torch.Tensor) else y)
  n = len(y)
  n_train, n_test = _split_sizes(n, test_size)
  classes, y_indices, class_counts = np.unique(y, return_inverse=True,
                                               return_counts=True)
  if np.min(class_counts) < 2:
    raise ValueError("The least populated class in y has only 1 member, "
                     "which is too few")
  if n_train < len(classes) or n_test < len(classes):
    raise ValueError(f"{n_train} train and {n_test} test rows cannot hold "
                     f"{len(classes)} classes each")
  class_indices = np.split(np.argsort(y_indices, kind="stable"),
                           np.cumsum(class_counts)[:-1])
  rng = np.random.RandomState(random_state)
  n_i = _approximate_mode(class_counts, n_train, rng)
  t_i = _approximate_mode(class_counts - n_i, n_test, rng)
  train: List[int] = []
  test: List[int] = []
  for i in range(len(classes)):
    perm = class_indices[i].take(rng.permutation(class_counts[i]),
                                 mode="clip")
    train.extend(perm[:n_i[i]])
    test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
  return rng.permutation(train), rng.permutation(test)


def _take(a, rows: np.ndarray):
  if isinstance(a, torch.Tensor):
    return a[torch.as_tensor(rows, device=a.device)]
  return np.asarray(a)[rows]


def train_test_split(*arrays, test_size: float = 0.25,
                     random_state: int = 0, stratify=None) -> list:
  """``[a_train, a_test, b_train, b_test, ...]`` as scikit-learn's
  ``train_test_split`` returns them (the same rows); tensors stay on their
  device."""
  n = len(arrays[0])
  if stratify is None:
    train, test = _train_test_indices(n, test_size, random_state)
  else:
    train, test = stratified_split(stratify, test_size, random_state)
  out = []
  for a in arrays:
    out += [_take(a, train), _take(a, test)]
  return out


# ---------------------------------------------------------------------------
# scaling and mutual information
# ---------------------------------------------------------------------------
class StandardScaler:
  """Zero mean, unit population std per column, the statistics in float64;
  a float32 input is transformed in float32 with them rounded to float32,
  as scikit-learn does."""

  def fit(self, X) -> "StandardScaler":
    X = as_tensor(X)
    x = X.to(torch.float64)
    n = x.shape[0]
    self.mean_ = x.mean(0)
    t = x - self.mean_
    self.var_ = ((t * t).sum(0) - t.sum(0) ** 2 / n) / n
    # scikit-learn's _is_constant_feature
    eps = EPSILON
    constant = self.var_ <= n * eps * self.var_ + (n * self.mean_ * eps) ** 2
    self.scale_ = torch.where(constant, torch.ones_like(self.var_),
                              torch.sqrt(self.var_))
    return self

  def transform(self, X) -> torch.Tensor:
    X = as_tensor(X, self.mean_.device)
    if not X.is_floating_point():
      X = X.to(torch.float64)
    return (X - self.mean_.to(X.dtype)) / self.scale_.to(X.dtype)

  def fit_transform(self, X) -> torch.Tensor:
    return self.fit(X).transform(X)


def _encode_columns(a: torch.Tensor) -> Tuple[torch.Tensor, List[int]]:
  """(n, c) labels -> (n, c) int64 codes 0..k_j-1 per column (in sorted
  order of the values) and the k_j."""
  codes, sizes = [], []
  for j in range(a.shape[1]):
    values, inv = torch.unique(a[:, j], return_inverse=True)
    codes.append(inv)
    sizes.append(int(values.numel()))
  return torch.stack(codes, 1), sizes


def mutual_info_matrix(labels_true, labels_pred, device=None
                       ) -> torch.Tensor:
  """[n_true_columns, n_pred_columns] of scikit-learn's
  ``mutual_info_score(labels_true[:, i], labels_pred[:, j])``: every
  contingency table from one ``bincount``, the sum in float64, in nats."""
  dev = device_of(labels_true, labels_pred, device=device)
  a = as_tensor(labels_true, dev)
  b = as_tensor(labels_pred, dev)
  a = a.reshape(len(a), -1)
  b = b.reshape(len(b), -1)
  ca, ka = _encode_columns(a)
  cb, kb = _encode_columns(b)
  ra, rb = max(ka), max(kb)
  na, nb = ca.shape[1], cb.shape[1]
  n = ca.shape[0]
  # one table of ra x rb cells per (i, j) pair
  pair = (torch.arange(na, device=dev)[:, None] * nb +
          torch.arange(nb, device=dev)[None, :])  # (na, nb)
  idx = (pair[None] * (ra * rb) + ca[:, :, None] * rb + cb[:, None, :])
  counts = torch.bincount(idx.reshape(-1), minlength=na * nb * ra * rb)
  table = counts.reshape(na, nb, ra, rb).to(torch.float64)
  total = float(n)
  pi = table.sum(3, keepdim=True)
  pj = table.sum(2, keepdim=True)
  nz = table > 0
  safe = torch.where(nz, table, torch.ones_like(table))
  contingency_nm = safe / total
  log_outer = -torch.log(pi * pj) + 2.0 * math.log(total)
  mi = (contingency_nm * (torch.log(safe) - math.log(total))
        + contingency_nm * log_outer)
  mi = torch.where(nz & (mi.abs() >= EPSILON), mi, torch.zeros_like(mi))
  out = torch.clamp(mi.sum((2, 3)), min=0.0)
  # a labelling with one value has zero entropy, so zero information
  single = ((torch.tensor(ka, device=dev) == 1)[:, None] |
            (torch.tensor(kb, device=dev) == 1)[None, :])
  return torch.where(single, torch.zeros_like(out), out)


def mutual_info_score(labels_true, labels_pred, device=None) -> float:
  """scikit-learn's ``mutual_info_score`` of two labellings, in nats."""
  return float(mutual_info_matrix(labels_true, labels_pred, device)[0, 0])


# ---------------------------------------------------------------------------
# logistic regression
# ---------------------------------------------------------------------------
class _LinearClassifier:
  """Prediction of a fitted linear classifier (``coef_``, ``intercept_``,
  ``classes_``): one raw score for two classes (the second class where it
  is positive), one a class otherwise (the first largest wins)."""

  def decision_function(self, X) -> torch.Tensor:
    X = as_tensor(X, self.coef_.device).to(torch.float64)
    raw = X @ self.coef_.T + self.intercept_
    return raw[:, 0] if raw.shape[1] == 1 else raw

  def predict(self, X) -> torch.Tensor:
    raw = self.decision_function(X)
    idx = (raw > 0).long() if raw.ndim == 1 else torch.argmax(raw, 1)
    return self.classes_[idx]

  def score(self, X, y) -> float:
    return accuracy(self.predict(X), as_tensor(y, self.coef_.device))


# Newton decrements below this share of the objective are within a few
# hundred roundings of its float64 sum, where a line search decides by
# rounding; the fit then takes full steps (see LogisticRegression)
NEWTON_NOISE = 1e-13


class LogisticRegression(_LinearClassifier):
  """L2-penalised logistic regression (scikit-learn's
  ``LogisticRegression(C)`` with lbfgs' objective): ``C·Σ_i loss_i +
  ½‖W‖²``, multinomial with one coefficient row per class for more than two
  classes, binomial with one row for two; intercepts are not penalised.
  Solved in float64 by Newton's method with a backtracking line search
  until the Newton decrement is below `tol` of the objective or a step no
  longer lowers it (below ``NEWTON_NOISE`` of it, where the objective's
  rounding cannot tell, full steps until the decrement stops shrinking:
  the fit then ends at the optimum on every device, not wherever
  rounding first rejects a step, up to about 1e-7 from it); each Newton
  step is a Cholesky solve of the dense
  Hessian ((rows·D)² float64: 8.6 GB at 64 classes of 512 features, and
  as much again for its factor)."""

  def __init__(self, C: float = 1.0, max_iter: int = 100,
               tol: float = 1e-20):
    self.C = float(C)
    self.max_iter = int(max_iter)
    self.tol = float(tol)

  def fit(self, X, y) -> "LogisticRegression":
    X = as_tensor(X).to(torch.float64)
    dev = X.device
    y = as_tensor(y, dev)
    self.classes_, yi = torch.unique(y, return_inverse=True)
    K = self.classes_.numel()
    if K < 2:
      raise ValueError("LogisticRegression needs at least 2 classes")
    n, d = X.shape
    rows = 1 if K == 2 else K
    Xt = torch.cat([X, torch.ones(n, 1, dtype=X.dtype, device=dev)], 1)
    D = d + 1
    if K == 2:
      Y = (yi == 1).to(torch.float64)[:, None]
    else:
      Y = torch.nn.functional.one_hot(yi, K).to(torch.float64)
    C = self.C
    # the penalty's diagonal: 1 on coefficients, 0 on intercepts
    pen = torch.ones(rows, D, dtype=torch.float64, device=dev)
    pen[:, -1] = 0.0
    pen = pen.reshape(-1)
    # the multinomial loss is unchanged when every intercept moves by the
    # same amount; that direction is orthogonal to every gradient, and this
    # term on it makes the Hessian definite without moving the step
    gauge = torch.zeros(rows, D, dtype=torch.float64, device=dev)
    if K > 2:
      gauge[:, -1] = 1.0 / math.sqrt(rows)
    gauge = gauge.reshape(-1)

    def objective(W):
      Z = Xt @ W.T  # (n, rows)
      if K == 2:
        loss = torch.nn.functional.softplus(Z) - Y * Z
      else:
        loss = torch.logsumexp(Z, 1, keepdim=True) - (Y * Z).sum(
            1, keepdim=True)
      return C * loss.sum() + 0.5 * (pen * W.reshape(-1) ** 2).sum()

    W = torch.zeros(rows, D, dtype=torch.float64, device=dev)
    f = objective(W)
    self.n_iter_ = 0
    small = math.inf  # the last decrement below NEWTON_NOISE
    for it in range(self.max_iter):
      Z = Xt @ W.T
      P = torch.sigmoid(Z) if K == 2 else torch.softmax(Z, 1)
      G = C * (P - Y).T @ Xt + pen.reshape(rows, D) * W  # (rows, D)
      g = G.reshape(-1)
      # Hessian: C·Σ_i (diag p_i - p_i p_iᵀ) ⊗ x_i x_iᵀ + penalty,
      # assembled in place (one (rows·D)² buffer)
      if K == 2:
        w8 = (P * (1 - P))[:, 0]
        H = C * (Xt * w8[:, None]).T @ Xt
      else:
        Q = (P[:, :, None] * Xt[:, None, :]).reshape(n, rows * D)
        H = Q.T @ Q
        del Q
        H.mul_(-C)
        for k in range(rows):  # the block diagonal, one class a block
          H[k * D:(k + 1) * D, k * D:(k + 1) * D].add_(
              (Xt * P[:, k:k + 1]).T @ Xt, alpha=C)
        H.add_(torch.outer(gauge, gauge))
      H.diagonal().add_(pen)
      # positive definite: a Cholesky solve, half an LU's work
      L, info = torch.linalg.cholesky_ex(H)
      del H
      if bool(info):
        raise RuntimeError("the logistic Hessian is not positive definite")
      step = -torch.cholesky_solve(g[:, None], L)[:, 0]
      del L
      decrement = float(-(g @ step))
      scale = max(abs(float(f)), 1.0)
      if decrement <= self.tol * scale:
        break
      if decrement <= NEWTON_NOISE * scale:
        # a gain below the objective's rounding, which the line search
        # cannot judge: full Newton steps, which converge quadratically
        # here, while the decrement still shrinks
        if decrement >= small:
          break
        small = decrement
        W = W + step.reshape(rows, D)
        f = objective(W)
        self.n_iter_ = it + 1
        continue
      t = 1.0
      while True:
        W_new = W + t * step.reshape(rows, D)
        f_new = objective(W_new)
        if float(f_new) <= float(f) - 1e-4 * t * decrement:
          break
        t *= 0.5
        if t < 1e-10:  # no descent left at float64's resolution
          break
      if not float(f_new) < float(f):
        break
      W, f = W_new, f_new
      self.n_iter_ = it + 1
    self.coef_ = W[:, :-1].contiguous()
    self.intercept_ = W[:, -1].contiguous()
    return self

  def predict_proba(self, X) -> torch.Tensor:
    raw = self.decision_function(X)
    if raw.ndim == 1:
      p = torch.sigmoid(raw)
      return torch.stack([1 - p, p], 1)
    return torch.softmax(raw, 1)


# ---------------------------------------------------------------------------
# linear SVM (liblinear's primal L2-loss SVC)
# ---------------------------------------------------------------------------
def fit_l2_svc(X: torch.Tensor, Y: torch.Tensor, Cw: torch.Tensor,
               max_iter: int = 100, tol: float = 1e-10) -> torch.Tensor:
  """Solve B independent L2-loss SVMs at once:
  ``min_w ½‖w‖² + Σ_i Cw_i·max(0, 1 - Y_i w·X_i)²`` for X (B, n, D)
  (the intercept, where wanted, is a constant column of X and so is
  penalised, as liblinear does), Y (B, n) in ±1 and per-row costs Cw
  (B, n); float64.  Generalised Newton: the Hessian of the rows inside
  the margin plus I, a step solved per problem, a backtracking line
  search.  A problem is done when its gradient is below `tol` of its
  first, or when no step along its Newton direction lowers its objective
  any more (its minimum, to rounding).  Returns w (B, D)."""
  B, n, D = X.shape
  w = torch.zeros(B, D, dtype=X.dtype, device=X.device)
  eye = torch.eye(D, dtype=X.dtype, device=X.device)

  def objective(w):
    m = torch.einsum("bnd,bd->bn", X, w)
    r = torch.clamp(1 - Y * m, min=0.0)
    return 0.5 * (w * w).sum(1) + (Cw * r * r).sum(1)

  g0 = None
  done = torch.zeros(B, dtype=torch.bool, device=X.device)
  for _ in range(max_iter):
    m = torch.einsum("bnd,bd->bn", X, w)
    active = (Cw * ((1 - Y * m) > 0)).to(X.dtype)
    g = w + 2 * torch.einsum("bn,bnd->bd", active * (m - Y), X)
    gmax = g.abs().amax(1)
    if g0 is None:
      g0 = torch.clamp(gmax, min=1.0)
    done = done | (gmax <= tol * g0)
    if bool(done.all()):
      break
    H = eye + 2 * torch.einsum("bn,bnd,bne->bde", active, X, X)
    step = -torch.linalg.solve(H, g)
    f0 = objective(w)
    slope = (g * step).sum(1)
    t = torch.ones(B, dtype=X.dtype, device=X.device)
    for _ in range(40):
      ok = done | (objective(w + t[:, None] * step) <= f0 + 1e-4 * t * slope)
      if bool(ok.all()):
        break
      t = torch.where(ok, t, 0.5 * t)
    done = done | ~ok  # no descent left along the Newton direction
    w = torch.where(done[:, None], w, w + t[:, None] * step)
  return w


def _balanced_weights(yi: torch.Tensor, K: int) -> torch.Tensor:
  """``n / (K·n_k)`` per class (scikit-learn's ``class_weight='balanced'``)."""
  counts = torch.bincount(yi, minlength=K).to(torch.float64)
  return yi.numel() / (K * counts)


def svc_problems(yi: torch.Tensor, K: int, C: float,
                 class_weight: Optional[str]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(Y, Cw), each (P, n), of liblinear's problems for encoded labels yi
  of K classes: one problem (class 1 positive) for K = 2, else one per
  class against the rest.  Each row's cost is C times its class weight,
  except that against the rest liblinear weighs only the positive rows."""
  weights = (_balanced_weights(yi, K) if class_weight == "balanced"
             else torch.ones(K, dtype=torch.float64, device=yi.device))
  if class_weight not in (None, "balanced"):
    raise NotImplementedError(f"class_weight={class_weight!r}")
  if K == 2:
    Y = torch.where(yi == 1, 1.0, -1.0).to(torch.float64)[None]
    return Y, (C * weights[yi])[None]
  pos = yi[None, :] == torch.arange(K, device=yi.device)[:, None]
  Y = torch.where(pos, 1.0, -1.0).to(torch.float64)
  Cw = torch.where(pos, C * weights[:, None], torch.full_like(Y, C))
  return Y, Cw


class LinearSVC(_LinearClassifier):
  """scikit-learn's ``LinearSVC`` with its defaults ``penalty='l2'``,
  ``loss='squared_hinge'``, ``intercept_scaling=1``: liblinear's primal
  problems (``svc_problems``) solved together by ``fit_l2_svc``."""

  def __init__(self, C: float = 1.0, class_weight: Optional[str] = None):
    self.C = float(C)
    self.class_weight = class_weight

  def fit(self, X, y) -> "LinearSVC":
    X = as_tensor(X).to(torch.float64)
    y = as_tensor(y, X.device)
    self.classes_, yi = torch.unique(y, return_inverse=True)
    K = self.classes_.numel()
    if K < 2:
      raise ValueError("LinearSVC needs at least 2 classes")
    Y, Cw = svc_problems(yi, K, self.C, self.class_weight)
    Xb = torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype,
                                  device=X.device)], 1)
    w = fit_l2_svc(Xb[None].expand(Y.shape[0], -1, -1), Y, Cw)
    self.coef_ = w[:, :-1].contiguous()
    self.intercept_ = w[:, -1].contiguous()
    return self


# ---------------------------------------------------------------------------
# gradient-boosted trees
# ---------------------------------------------------------------------------
RAND_R_MAX = 2147483647  # scikit-learn's ``utils/_random.pxd``
# Cody and Waite's split of ln 2 (fdlibm's ``e_exp.c``): k·_LN2_HI is exact
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_EXP_TAYLOR = tuple(1.0 / math.factorial(i) for i in range(14))


def _pairwise_sum(v: torch.Tensor) -> torch.Tensor:
  """The sum over v's last dimension in one fixed order (zero-padded to a
  power of two, then halves added elementwise): the same bits on every
  device, which torch's reductions do not promise."""
  n = v.shape[-1]
  w = 1 << max(n - 1, 0).bit_length()
  if w > n:
    v = torch.nn.functional.pad(v, (0, w - n))
  while v.shape[-1] > 1:
    h = v.shape[-1] // 2
    v = v[..., :h] + v[..., h:]
  return v[..., 0]


def _exp_nonpositive(x: torch.Tensor) -> torch.Tensor:
  """exp(x) for float64 x <= 0 (clamped at -708, where it is still
  normal) from IEEE-rounded products and sums and an exact power of two:
  the same bits on every device, where ``torch.exp``'s last bit differs
  between the CPU's library and CUDA's.  Within about 2 ulp of exp: a
  degree-13 Taylor polynomial on |r| <= ln2/2 (remainder below 4e-18)."""
  x = torch.clamp(x, min=-708.0)
  k = torch.round(x * (1.0 / math.log(2.0)))
  r = (x - k * _LN2_HI) - k * _LN2_LO
  p = torch.full_like(r, _EXP_TAYLOR[-1])
  for c in reversed(_EXP_TAYLOR[:-1]):
    p = p * r + c
  two_k = torch.bitwise_left_shift(k.to(torch.int64) + 1023, 52)
  return p * two_k.view(torch.float64)


def _portable_probabilities(raw: torch.Tensor) -> torch.Tensor:
  """The log-loss's probabilities of raw scores (n, K), as ``torch.sigmoid``
  (K = 1) or ``torch.softmax`` over the classes, from ``_exp_nonpositive``
  and ``_pairwise_sum``: the same bits on every device."""
  if raw.shape[1] == 1:
    e = _exp_nonpositive(-raw.abs())
    return torch.where(raw >= 0, 1.0 / (1.0 + e), e / (1.0 + e))
  e = _exp_nonpositive(raw - raw.amax(1, keepdim=True))
  return e / _pairwise_sum(e)[:, None]


class _SplitterDraws:
  """The feature order in which scikit-learn's ``BestSplitter`` visits the
  features of each node of one tree (``tree/_splitter.pyx``,
  ``node_split_best``): its xorshift ``rand_r`` seeded by one
  ``randint(0, RAND_R_MAX)`` of the ensemble's ``RandomState``, its
  ``features`` array (permuted in place from node to node) and its
  constant-feature bookkeeping, replayed node by node in the depth-first
  order in which scikit-learn grows a tree."""

  def __init__(self, seed: int, n_features: int):
    self.state = int(seed) & 0xFFFFFFFF
    self.features = list(range(n_features))
    self.constant_features = [0] * n_features

  def _rand_int(self, low: int, high: int) -> int:
    s = self.state or 1  # DEFAULT_SEED
    s ^= (s << 13) & 0xFFFFFFFF
    s ^= s >> 17
    s ^= (s << 5) & 0xFFFFFFFF
    self.state = s
    return low + (s % (RAND_R_MAX + 1)) % (high - low)

  def visit(self, n_known_constants: int, constant: Sequence[bool],
            max_features: Optional[int] = None) -> Tuple[List[int], int]:
    """(the non-constant features in visit order, the node's constant
    count for its children) for a node with `n_known_constants` inherited
    and `constant[f]` true where feature f spans at most
    ``FEATURE_THRESHOLD`` in the node; at most `max_features` draws (every
    feature by default) unless all drawn so far were constant."""
    features = self.features
    f_i = len(features)
    max_features = f_i if max_features is None else int(max_features)
    n_drawn = n_found = n_visited = 0
    n_total = n_known_constants
    visited: List[int] = []
    while f_i > n_total and (n_visited < max_features or
                             n_visited <= n_found + n_drawn):
      n_visited += 1
      f_j = self._rand_int(n_drawn, f_i - n_found)
      if f_j < n_known_constants:
        features[n_drawn], features[f_j] = features[f_j], features[n_drawn]
        n_drawn += 1
        continue
      f_j += n_found
      if constant[features[f_j]]:
        features[f_j], features[n_total] = features[n_total], features[f_j]
        n_found += 1
        n_total += 1
        continue
      f_i -= 1
      features[f_i], features[f_j] = features[f_j], features[f_i]
      visited.append(features[f_i])
    features[:n_known_constants] = self.constant_features[:n_known_constants]
    self.constant_features[n_known_constants:n_known_constants + n_found] = \
        features[n_known_constants:n_known_constants + n_found]
    return visited, n_total


_DRAWS_LIB = []  # the loaded splitter_draws library


def _draws_library():
  """``csrc/splitter_draws.cpp`` built with g++ and loaded; raises where
  it cannot be built, as the native IO engine does."""
  if not _DRAWS_LIB:
    import ctypes

    from odin_tpu_torch import _build
    lib = ctypes.CDLL(str(_build.build_host("splitter_draws")))
    i64, p = ctypes.c_int64, ctypes.c_void_p
    lib.splitter_visit_many.argtypes = [i64, p, p, p, p, i64, p, p, i64,
                                        p, p, p]
    lib.splitter_visit_many.restype = None
    _DRAWS_LIB.append(lib)
  return _DRAWS_LIB[0]


class SplitterDrawsBatch:
  """``_SplitterDraws`` for many trees at once: each tree's ``rand_r``
  state, ``features`` and ``constant_features`` as rows of numpy arrays,
  and ``visit`` replaying one node of each of several trees in one call of
  ``csrc/splitter_draws.cpp`` (``native=False``: ``_SplitterDraws``'
  Python replay, the library's reference in the tests)."""

  def __init__(self, seeds: Sequence[int], n_features: int):
    self.states = np.asarray([int(s) & 0xFFFFFFFF for s in seeds],
                             dtype=np.uint32)
    self.features = np.tile(np.arange(n_features, dtype=np.int64),
                            (len(seeds), 1))
    self.constant_features = np.zeros_like(self.features)

  def visit(self, rows: Sequence[int], n_known: Sequence[int],
            constant: np.ndarray, max_features: Optional[int] = None,
            native: bool = True):
    """For tree rows[i] with n_known[i] inherited constants and the node's
    constant mask constant[i] (d,): (visited (m, d), the first n_visited[i]
    of row i in visit order; n_visited (m,); the node's constant count
    (m,))."""
    m = len(rows)
    d = self.features.shape[1]
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    n_known = np.ascontiguousarray(n_known, dtype=np.int64)
    constant = np.ascontiguousarray(constant, dtype=np.uint8).reshape(m, d)
    visited = np.zeros((m, d), np.int64)
    n_visited = np.zeros(m, np.int64)
    n_total = np.zeros(m, np.int64)
    mf = d if max_features is None else int(max_features)
    if native:
      lib = _draws_library()
      ptr = lambda a: a.ctypes.data
      lib.splitter_visit_many(m, ptr(rows), ptr(self.states),
                              ptr(self.features), ptr(self.constant_features),
                              d, ptr(n_known), ptr(constant), mf,
                              ptr(visited), ptr(n_visited), ptr(n_total))
      return visited, n_visited, n_total
    for i, t in enumerate(rows):
      one = _SplitterDraws(int(self.states[t]), d)
      one.features = self.features[t].tolist()
      one.constant_features = self.constant_features[t].tolist()
      v, n_total[i] = one.visit(int(n_known[i]), constant[i].astype(bool),
                                mf)
      visited[i, :len(v)] = v
      n_visited[i] = len(v)
      self.states[t] = one.state
      self.features[t] = one.features
      self.constant_features[t] = one.constant_features
    return visited, n_visited, n_total


def _check_random_state(random_state) -> np.random.RandomState:
  if isinstance(random_state, np.random.RandomState):
    return random_state
  return np.random.RandomState(random_state)


class GradientBoostingClassifier:
  """scikit-learn's ``GradientBoostingClassifier`` with log-loss,
  ``subsample=1``, ``min_samples_split=2``, ``min_samples_leaf=1``,
  ``max_features=None`` and the squared-error tree criterion, on the device
  of X.

  As scikit-learn: X is cast to float32; the first raw prediction is the
  log prior (the symmetric multinomial logit for more than two classes);
  each stage fits one regression tree to the negative gradient per class
  (one for two classes), choosing at each node the split that maximises
  ``S_L²/n_L + S_R²/n_R`` over every feature and every gap between
  adjacent values more than ``FEATURE_THRESHOLD`` apart, at the midpoint
  of the two values; a node is a leaf at `max_depth`, below 2 rows or at
  impurity ``<= EPSILON``; a leaf's value is the Newton step
  ``Σ g / Σ p(1-p)`` (times ``(K-1)/K`` for K classes).

  The K trees of a stage grow together, node by node in scikit-learn's
  depth-first order, each node's search over every tree, feature and row
  at once: the rows stay presorted per feature, so masked cumulative sums
  of the residuals give every candidate's left sum and an argmax picks the
  split.  The sums run in integers (the residuals on a grid of about
  2^-39), so they are exact and every gain is the same number on every
  device.  So are the residuals: the log prior is taken on the host, the
  probabilities come from ``_portable_probabilities``, and each node's
  impurity and each leaf's value from ``_pairwise_sum``; a fit on the card
  is the CPU's, bit for bit.

  Ties: splits of equal gain are frequent where a tree's residuals take
  few values (the first stage has two per tree, and a split that isolates
  one row can often be made on several features).  scikit-learn keeps the
  first best split in the order it visits the features, which it draws
  from `random_state`; the port replays those draws (``_SplitterDraws``,
  for all trees of a stage at once in ``SplitterDrawsBatch``) and keeps
  the first best in the same order.  Where scikit-learn's own
  float sums round two equal gains apart, its choice follows the rounding
  and may differ from the port's."""

  def __init__(self, n_estimators: int = 100, learning_rate: float = 0.1,
               max_depth: int = 3, random_state=None, **kwargs):
    unsupported = {k: v for k, v in kwargs.items() if not (
        (k == "loss" and v == "log_loss") or (k == "subsample" and v == 1.0)
        or (k == "criterion" and v in ("friedman_mse", "squared_error")))}
    if unsupported:
      raise NotImplementedError(
          f"GradientBoostingClassifier options {sorted(unsupported)} are not "
          "ported (ROADMAP.md queue 1)")
    self.n_estimators = int(n_estimators)
    self.learning_rate = float(learning_rate)
    self.max_depth = int(max_depth)
    self.random_state = random_state

  # -- fitting ----------------------------------------------------------------
  def fit(self, X, y) -> "GradientBoostingClassifier":
    X = as_tensor(X).to(torch.float32)
    dev = X.device
    y = as_tensor(y, dev)
    self.classes_, yi = torch.unique(y, return_inverse=True)
    n_classes = self.classes_.numel()
    if n_classes < 2:
      raise ValueError("GradientBoostingClassifier needs at least 2 classes")
    self.binary_ = n_classes == 2
    K = 1 if self.binary_ else n_classes
    n, d = X.shape
    self.n_features_in_ = d
    eps = EPSILON
    # the log prior on the host: numpy's log, whatever the device
    prior = np.bincount(yi.cpu().numpy(), minlength=n_classes) / n
    if self.binary_:
      p1 = np.clip(prior[1:], eps, 1 - eps)
      init = np.log(p1 / (1 - p1))
      Y = (yi == 1).to(torch.float64)[:, None]
    else:
      logp = np.log(np.clip(prior, eps, 1 - eps))
      init = logp - logp.mean()
      Y = torch.nn.functional.one_hot(yi, K).to(torch.float64)
    self.init_raw_ = torch.as_tensor(init, dtype=torch.float64, device=dev)
    raw = self.init_raw_.expand(n, K).clone()
    XT64 = X.T.to(torch.float64).contiguous()  # (d, n), float32 values
    order = torch.argsort(X.T, dim=1, stable=True)  # presorted once
    rng = _check_random_state(self.random_state)
    self.trees_ = []
    for _ in range(self.n_estimators):
      g = Y - _portable_probabilities(raw)
      draws = SplitterDrawsBatch([rng.randint(0, RAND_R_MAX)
                                  for _ in range(K)], d)
      tree, leaf = self._grow(XT64, order, g.T.contiguous(), Y.T, draws)
      raw = raw + self.learning_rate * tree["value"].gather(1, leaf).T
      self.trees_.append(tree)
    return self

  def _grow(self, XT64: torch.Tensor, order: torch.Tensor, gT: torch.Tensor,
            YT: torch.Tensor, draws: SplitterDrawsBatch):
    """One stage's K trees on the residuals gT (K, n); -> (the trees, the
    leaf of each training row in each tree (K, n))."""
    d, n = XT64.shape
    K = gT.shape[0]
    dev = gT.device
    H = 2 ** (self.max_depth + 1) - 1  # heap layout, children 2h+1, 2h+2
    feature = torch.zeros(K, H, dtype=torch.long, device=dev)
    threshold = torch.zeros(K, H, dtype=torch.float64, device=dev)
    is_split = torch.zeros(K, H, dtype=torch.bool, device=dev)
    count = torch.zeros(K, H, dtype=torch.float64, device=dev)
    impurity = torch.zeros(K, H, dtype=torch.float64, device=dev)
    # the residuals (all in [-1, 1]) as integers on a grid of 2^-q,
    # q = 52 - ceil(log2(n + 1)): every prefix sum is exact (below 2^53)
    quantum = 2.0 ** (52 - math.ceil(math.log2(n + 1)))
    gq = torch.round(gT * quantum).to(torch.int64)
    g_sorted = gq[:, order]  # (K, d, n): each feature's rows by value
    x_sorted = XT64.gather(1, order)  # (d, n)
    x_pad = torch.cat([x_sorted, x_sorted[:, -1:]], 1)
    pos = torch.arange(n, device=dev)
    node = torch.zeros(K, n, dtype=torch.long, device=dev)  # heap index
    n_const = np.zeros((K, H), dtype=np.int64)

    def stats(h, mask):
      """Row count, impurity of heap node h over the rows in mask (K, n),
      the impurity as the mean squared deviation (0 to rounding where
      the residuals are equal, far below ``EPSILON``)."""
      c = mask.sum(1).to(torch.float64)
      safe = torch.clamp(c, min=1.0)
      mean = _pairwise_sum(torch.where(mask, gT, 0.0)) / safe
      dev2 = (gT - mean[:, None]) * (gT - mean[:, None])
      count[:, h] = c
      impurity[:, h] = _pairwise_sum(torch.where(mask, dev2, 0.0)) / safe

    stats(0, torch.ones(K, n, dtype=torch.bool, device=dev))
    exists = torch.zeros(K, H, dtype=torch.bool, device=dev)
    exists[:, 0] = True

    def dfs(h, depth):
      if depth < self.max_depth:
        yield h
        yield from dfs(2 * h + 1, depth + 1)
        yield from dfs(2 * h + 2, depth + 1)

    for h in dfs(0, 0):
      searched = exists[:, h] & (count[:, h] >= 2) & (impurity[:, h] > EPSILON)
      in_node = node == h
      inf = torch.tensor(math.inf, dtype=torch.float64, device=dev)
      xmin = torch.where(in_node[:, None, :], XT64[None], inf).amin(2)
      xmax = torch.where(in_node[:, None, :], XT64[None], -inf).amax(2)
      constant = (xmax <= xmin + FEATURE_THRESHOLD).cpu().numpy()
      searched_h = searched.cpu().numpy()
      rank = np.full((K, d), d, dtype=np.int64)
      rows = np.flatnonzero(searched_h)
      visited, n_visited, n_total = draws.visit(rows, n_const[rows, h],
                                                constant[rows])
      for i, k in enumerate(rows):
        rank[k, visited[i, :n_visited[i]]] = np.arange(n_visited[i])
        if 2 * h + 2 < H:
          n_const[k, 2 * h + 1:2 * h + 3] = n_total[i]
      if not searched_h.any():
        continue
      # masked prefix sums over each feature's presorted rows
      m_sorted = in_node[:, order]  # (K, d, n)
      cs = torch.cumsum(torch.where(m_sorted, g_sorted, 0), 2)
      n_left = torch.cumsum(m_sorted.to(torch.int64), 2)
      n_h = count[:, h].to(torch.int64)[:, None, None]
      # the value of the next row of the node in each feature's order
      idx = torch.where(m_sorted, pos, n)
      nxt = torch.flip(torch.cummin(torch.flip(idx, [2]), 2).values, [2])
      nxt = torch.cat([nxt[:, :, 1:], torch.full_like(nxt[:, :, :1], n)], 2)
      x_next = x_pad[None].expand(K, d, n + 1).gather(2, nxt)
      xs = x_sorted[None]
      ok = (m_sorted & (n_left < n_h) & (x_next > xs + FEATURE_THRESHOLD) &
            searched[:, None, None])
      s_left = cs.to(torch.float64) / quantum
      s_right = (cs[:, :, -1:] - cs).to(torch.float64) / quantum
      nl = n_left.to(torch.float64)
      nr = torch.clamp((n_h - n_left).to(torch.float64), min=1.0)
      proxy = torch.where(ok, s_left * s_left / nl + s_right * s_right / nr,
                          torch.full_like(s_left, -math.inf))
      # scikit-learn keeps the first strictly better split in its visit
      # order: among the features reaching the best gain, the first
      # visited, and in it the first position
      best_f = proxy.amax(2)  # (K, d)
      best = best_f.amax(1)  # (K,)
      rank_t = torch.as_tensor(rank, device=dev)
      tie_rank = torch.where(best_f == best[:, None], rank_t,
                             torch.full_like(rank_t, d + 1))
      j = torch.argmin(tie_rank, 1)  # (K,)
      row = proxy.gather(1, j[:, None, None].expand(K, 1, n))[:, 0]
      p = torch.argmax((row == best[:, None]).to(torch.int32), 1)
      x_lo = x_sorted[j, p]
      x_hi = x_next.gather(1, j[:, None, None].expand(K, 1, n))[:, 0].gather(
          1, p[:, None])[:, 0]
      found = torch.isfinite(best)
      is_split[:, h] = found
      feature[:, h] = torch.where(found, j, torch.zeros_like(j))
      threshold[:, h] = torch.where(found, x_lo / 2.0 + x_hi / 2.0,
                                    torch.zeros_like(x_lo))
      if 2 * h + 2 < H:
        go = in_node & found[:, None]
        left = XT64[feature[:, h]] <= threshold[:, h, None]  # (K, n)
        node = torch.where(go, torch.where(left, 2 * h + 1, 2 * h + 2), node)
        for c in (2 * h + 1, 2 * h + 2):
          exists[:, c] = found
          stats(c, node == c)
    leaf = node
    # leaf values: scikit-learn's Newton step on the leaf's rows

    def leaf_sum(v):
      return torch.stack([_pairwise_sum(torch.where(leaf == h, v, 0.0))
                          for h in range(H)], 1)

    prob = YT - gT
    n_leaf = torch.clamp(leaf_sum(torch.ones_like(gT)), min=1.0)
    numerator = leaf_sum(gT) / n_leaf
    if K > 1:
      numerator = numerator * ((K - 1) / K)  # one product, as scikit-learn
    denominator = leaf_sum(prob * (1 - prob)) / n_leaf
    tiny = denominator.abs() < 1e-150  # scikit-learn's _safe_divide
    value = torch.where(tiny, torch.zeros_like(numerator),
                        numerator / torch.where(tiny, torch.ones_like(
                            denominator), denominator))
    # each split's weighted impurity decrease, per feature, over the root's
    # row count (``Tree.compute_feature_importances(normalize=False)``)
    hh = torch.arange(H, device=dev)
    lc, rc = (2 * hh + 1).clamp(max=H - 1), (2 * hh + 2).clamp(max=H - 1)
    wi = count * impurity
    decrease = torch.where(is_split, wi - wi[:, lc] - wi[:, rc],
                           torch.zeros_like(wi))
    importance = torch.zeros(K, self.n_features_in_, dtype=torch.float64,
                             device=dev).scatter_add_(1, feature, decrease)
    importance = importance / count[:, :1]
    return dict(feature=feature, threshold=threshold, is_split=is_split,
                value=value, importance=importance), leaf

  def _apply(self, tree: dict, XT64: torch.Tensor) -> torch.Tensor:
    """The leaf (heap index) of each row in each of the stage's trees,
    (K, n), for features XT64 (d, n) holding float32 values."""
    K = tree["value"].shape[0]
    node = torch.zeros(K, XT64.shape[1], dtype=torch.long,
                       device=XT64.device)
    for _ in range(self.max_depth):
      split = tree["is_split"].gather(1, node)
      x = XT64.gather(0, tree["feature"].gather(1, node))
      left = x <= tree["threshold"].gather(1, node)
      node = torch.where(split, torch.where(left, 2 * node + 1, 2 * node + 2),
                         node)
    return node

  # -- prediction -------------------------------------------------------------
  def decision_function(self, X) -> torch.Tensor:
    XT64 = as_tensor(X, self.init_raw_.device).to(torch.float32).T.to(
        torch.float64)
    raw = self.init_raw_.expand(XT64.shape[1], -1).clone()
    for tree in self.trees_:
      raw = raw + self.learning_rate * tree["value"].gather(
          1, self._apply(tree, XT64)).T
    return raw[:, 0] if self.binary_ else raw

  def predict(self, X) -> torch.Tensor:
    raw = self.decision_function(X)
    idx = (raw >= 0).long() if raw.ndim == 1 else torch.argmax(raw, 1)
    return self.classes_[idx]

  def predict_proba(self, X) -> torch.Tensor:
    """The log-loss's probabilities: the sigmoid of the raw score (as
    [1 − p, p]) for two classes, its softmax for more."""
    raw = self.decision_function(X)
    if raw.ndim == 1:
      p = torch.sigmoid(raw)
      return torch.stack([1 - p, p], 1)
    return torch.softmax(raw, 1)

  def score(self, X, y) -> float:
    return accuracy(self.predict(X), as_tensor(y, self.init_raw_.device))

  @property
  def feature_importances_(self) -> torch.Tensor:
    """Mean over the trees with more than one node of each tree's
    unnormalised impurity decrease, normalised to sum to 1 (zeros where
    no tree split)."""
    imps = torch.cat([t["importance"] for t in self.trees_])
    relevant = torch.cat([t["is_split"][:, 0] for t in self.trees_])
    if not bool(relevant.any()):
      return torch.zeros(self.n_features_in_, dtype=torch.float64,
                         device=imps.device)
    avg = imps[relevant].mean(0)
    return avg / avg.sum()
