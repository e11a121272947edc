"""scikit-learn 1.9's ``SVC`` carried in torch, on the device of its input
(libsvm's C-SVC through ``sklearn/svm/_base.py`` and ``_classes.py``).

As libsvm: one binary problem for each pair of classes (i < j in sorted
order, class i positive, its rows first, each class's rows in their
original order), the dual ``min ½αᵀQα − Σα, 0 <= α <= C, yᵀα = 0`` with
``Q_ij = y_i y_j K(x_i, x_j)`` held in single precision (libsvm's
``Qfloat``) and its diagonal in double; SMO with libsvm's second-order
working-set selection (the maximal violator i, then the j of the largest
decrease of the objective, the last of equal candidates as libsvm's
``>=``/``<=`` keep them), its two-variable update and clipping, stopping
when the maximal violation falls below `tol`; the bias ``−ρ`` averaged
over the free support vectors (the midpoint of the bounds where none is
free).  Every problem of a fit (every pair, and with ``probability=True``
every pair's five cross-validation folds) is solved in one batch on the
device, each problem stopping on its own.  libsvm's shrinking changes only
the order of its iterations, not the optimum it stops near, and is not
replayed.

The kernels: ``linear``, ``rbf``, ``poly`` and ``sigmoid``, with ``gamma``
``'scale'`` (1 / (d·Var X)), ``'auto'`` (1 / d) or a number.  Decision
values are ``Σ α_s y_s K(x_s, x) − ρ`` per pair; ``decision_function`` is
scikit-learn's (the negated pair value for two classes, the
``_ovr_decision_function`` of votes and confidences for more with
``decision_function_shape='ovr'``); ``predict`` is libsvm's vote.

``probability=True`` follows libsvm's ``svm_binary_svc_probability``: each
pair's rows shuffled, five folds, each fold's decision values from an SVM
trained on the other four (±1 where those hold one class only), then
Platt's sigmoid fitted by libsvm's Newton iteration with backtracking
(``sigmoid_train``); ``predict_proba`` couples the pairwise probabilities
(clipped to [1e-7, 1 − 1e-7]) by Wu, Lin and Weng's second method
(``multiclass_probability``, for two classes too, as scikit-learn's libsvm
does), every test row at once.  libsvm shuffles
with its own generator seeded from ``random_state`` (unseeded by default,
so scikit-learn's own probabilities change from run to run); the port
shuffles each pair's rows with ``RandomState(seed).permutation`` from a
seed drawn the same way, so its folds are not libsvm's.

Everything runs in float64, as libsvm does.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from odin_tpu_torch.device import as_tensor, device_of, iterate

__all__ = ["SVC", "fast_svc", "solve_smo"]

F64 = torch.float64
TAU = 1e-12  # libsvm's TAU
MIN_PROB = 1e-7  # libsvm's svm_predict_probability clip
N_FOLD = 5
# problems a batch of solve_smo holds at most: Q takes B·L² doubles
_SMO_ELEMENTS = 2 ** 26
SMO_UNROLL = 64  # SMO iterations in one CUDA graph


def _kernel(A: torch.Tensor, B: torch.Tensor, kernel: str, gamma: float,
            coef0: float, degree: int) -> torch.Tensor:
  """libsvm's kernel values K(a, b), float64."""
  if kernel == "linear":
    return A @ B.T
  if kernel == "rbf":
    sq = (A * A).sum(1)[:, None] + (B * B).sum(1)[None] - 2.0 * (A @ B.T)
    return torch.exp(-gamma * sq)
  if kernel == "poly":
    return (gamma * (A @ B.T) + coef0) ** degree
  if kernel == "sigmoid":
    return torch.tanh(gamma * (A @ B.T) + coef0)
  raise NotImplementedError(f"kernel={kernel!r} is not ported")


def _last_argmax(x: torch.Tensor) -> torch.Tensor:
  """The index of the last maximum along the last axis."""
  n = x.shape[-1]
  return n - 1 - torch.argmax(torch.flip(x, [-1]), dim=-1)


def solve_smo(K: torch.Tensor, rows: torch.Tensor, y: torch.Tensor,
              C: torch.Tensor, tol: float = 1e-3,
              max_iter: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
  """Solve B C-SVC duals at once by libsvm's SMO (see the module
  docstring).  K (n, n): the kernel over every row; rows (B, L): each
  problem's rows into K (padding anything); y (B, L): ±1, 0 for padding;
  C (B, L): each variable's bound, 0 for padding (a padded variable sits
  at both bounds and is never chosen).  Returns (α (B, L), ρ (B,)).

  On the card the iterations run as CUDA graphs of ``SMO_UNROLL``
  iterations (``device.iterate``), replayed until every problem has
  stopped (a stopped problem is left as it is by the iterations after its
  stop); on the CPU they run eagerly."""
  B, L = rows.shape
  dev = K.device
  bi = torch.arange(B, device=dev)
  QD = K[rows, rows]  # (B, L), double
  yy = y[:, :, None] * y[:, None, :]
  Q = (yy * K[rows[:, :, None], rows[:, None, :]]).to(torch.float32).to(F64)
  real = y != 0
  pos = y > 0
  alpha = torch.zeros(B, L, dtype=F64, device=dev)
  G = torch.where(real, -torch.ones_like(alpha), torch.zeros_like(alpha))
  done = ~real.any(1)
  inf = torch.tensor(math.inf, dtype=F64, device=dev)
  tiny = torch.full((B,), TAU, dtype=F64, device=dev)

  def col(a, k):
    return a.gather(1, k[:, None])[:, 0]

  def step():
    """One SMO iteration of every problem that has not stopped, in place
    on alpha, G and done."""
    upper = alpha >= C
    lower = alpha <= 0
    up = real & torch.where(pos, ~upper, ~lower)
    low = real & torch.where(pos, ~lower, ~upper)
    v = y * G
    score_i = torch.where(up, -v, -inf)
    i = _last_argmax(score_i)
    Gmax = col(score_i, i)
    Gmax2 = torch.where(low, v, -inf).amax(1)
    grad_diff = Gmax[:, None] + v
    Qi = Q[bi, i]  # (B, L): row i
    yi = col(y, i)
    QDi = col(QD, i)
    quad = QDi[:, None] + QD - 2.0 * yi[:, None] * y * Qi
    quad = torch.where(quad > 0, quad, TAU)
    cand = low & (grad_diff > 0)
    obj = torch.where(cand, -(grad_diff * grad_diff) / quad, inf)
    j = _last_argmax(-obj)
    stop = (Gmax + Gmax2 < tol) | ~cand.any(1) | ~torch.isfinite(Gmax)
    done.logical_or_(stop)
    # libsvm's two-variable update, then its clipping to the box
    yj, Ci, Cj = col(y, j), col(C, i), col(C, j)
    ai, aj, Gi, Gj = col(alpha, i), col(alpha, j), col(G, i), col(G, j)
    QDj, Qij = col(QD, j), col(Qi, j)
    # y_i != y_j
    q1 = QDi + QDj + 2 * Qij
    delta = (-Gi - Gj) / torch.where(q1 > 0, q1, tiny)
    diff = ai - aj
    ni, nj = ai + delta, aj + delta
    c = (diff > 0) & (nj < 0)
    ni, nj = torch.where(c, diff, ni), torch.where(c, 0.0, nj)
    c = (diff <= 0) & (ni < 0)
    ni, nj = torch.where(c, 0.0, ni), torch.where(c, -diff, nj)
    c = (diff > Ci - Cj) & (ni > Ci)
    ni, nj = torch.where(c, Ci, ni), torch.where(c, Ci - diff, nj)
    c = (diff <= Ci - Cj) & (nj > Cj)
    ni, nj = torch.where(c, Cj + diff, ni), torch.where(c, Cj, nj)
    # y_i == y_j
    q2 = QDi + QDj - 2 * Qij
    delta2 = (Gi - Gj) / torch.where(q2 > 0, q2, tiny)
    s = ai + aj
    mi, mj = ai - delta2, aj + delta2
    c = (s > Ci) & (mi > Ci)
    mi, mj = torch.where(c, Ci, mi), torch.where(c, s - Ci, mj)
    c = (s <= Ci) & (mj < 0)
    mi, mj = torch.where(c, s, mi), torch.where(c, 0.0, mj)
    c = (s > Cj) & (mj > Cj)
    mi, mj = torch.where(c, s - Cj, mi), torch.where(c, Cj, mj)
    c = (s <= Cj) & (mi < 0)
    mi, mj = torch.where(c, 0.0, mi), torch.where(c, s, mj)
    same = yi == yj
    go = ~done
    ni = torch.where(go, torch.where(same, mi, ni), ai)
    nj = torch.where(go, torch.where(same, mj, nj), aj)
    dai, daj = ni - ai, nj - aj
    alpha.scatter_(1, i[:, None], ni[:, None])
    alpha.scatter_(1, j[:, None], nj[:, None])
    G.add_(Qi * dai[:, None] + Q[bi, j] * daj[:, None])

  iterate(step, lambda: bool(done.all()), dev,
          max_iter if max_iter > 0 else math.inf, SMO_UNROLL)
  # libsvm's calculate_rho
  upper = alpha >= C
  lower = alpha <= 0
  free = real & ~upper & ~lower
  yG = y * G
  ub_c = real & ((upper & ~pos) | (lower & pos))
  lb_c = real & ((upper & pos) | (lower & ~pos))
  ub = torch.where(ub_c, yG, inf).amin(1)
  lb = torch.where(lb_c, yG, -inf).amax(1)
  n_free = free.sum(1)
  rho = torch.where(n_free > 0,
                    torch.where(free, yG, torch.zeros_like(yG)).sum(1) /
                    torch.clamp(n_free, min=1).to(F64), (ub + lb) / 2)
  return alpha, rho


def _solve_batched(K, problems, tol, max_iter):
  """solve_smo over a list of (rows, y, C) numpy problems, in batches of
  at most ``_SMO_ELEMENTS`` Q entries; -> [(α, ρ)] on K's device."""
  out: List = [None] * len(problems)
  order = sorted(range(len(problems)), key=lambda p: len(problems[p][0]))
  start = 0
  while start < len(order):
    L = len(problems[order[start]][0])
    stop = start
    while stop < len(order):
      L = max(L, len(problems[order[stop]][0]))
      if (stop - start + 1) * L * L > _SMO_ELEMENTS and stop > start:
        break
      stop += 1
    batch = order[start:stop]
    L = max(len(problems[p][0]) for p in batch)
    rows = np.zeros((len(batch), L), np.int64)
    y = np.zeros((len(batch), L))
    C = np.zeros((len(batch), L))
    for b, p in enumerate(batch):
      r, yy, cc = problems[p]
      rows[b, :len(r)], y[b, :len(r)], C[b, :len(r)] = r, yy, cc
    dev = K.device
    alpha, rho = solve_smo(K, torch.from_numpy(rows).to(dev),
                           torch.from_numpy(y).to(dev),
                           torch.from_numpy(C).to(dev), tol, max_iter)
    for b, p in enumerate(batch):
      n = len(problems[p][0])
      out[p] = (alpha[b, :n], rho[b])
    start = stop
  return out


def sigmoid_train(dec: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """libsvm's ``sigmoid_train`` (Platt's sigmoid by Newton's method with
  backtracking, Lin et al.'s targets) for P problems at once: dec, labels
  (±1) and mask (P, l).  Returns (A, B), each (P,)."""
  P = dec.shape[0]
  dev = dec.device
  m = mask.to(F64)
  prior1 = ((labels > 0) & mask).sum(1).to(F64)
  prior0 = ((labels <= 0) & mask).sum(1).to(F64)
  hi = (prior1 + 1.0) / (prior1 + 2.0)
  lo = 1 / (prior0 + 2.0)
  t = torch.where(labels > 0, hi[:, None], lo[:, None])
  A = torch.zeros(P, dtype=F64, device=dev)
  B = torch.log((prior0 + 1.0) / (prior1 + 1.0))

  def fval(A, B):
    f = dec * A[:, None] + B[:, None]
    v = torch.where(f >= 0, t * f + torch.log1p(torch.exp(-f)),
                    (t - 1) * f + torch.log1p(torch.exp(f)))
    return (v * m).sum(1)

  f0 = fval(A, B)
  active = torch.ones(P, dtype=torch.bool, device=dev)
  for _ in range(100):
    f = dec * A[:, None] + B[:, None]
    p = torch.where(f >= 0, torch.exp(-f) / (1.0 + torch.exp(-f)),
                    1.0 / (1.0 + torch.exp(f)))
    q = 1.0 - p
    d2 = p * q * m
    h11 = 1e-12 + (dec * dec * d2).sum(1)
    h22 = 1e-12 + d2.sum(1)
    h21 = (dec * d2).sum(1)
    d1 = (t - p) * m
    g1 = (dec * d1).sum(1)
    g2 = d1.sum(1)
    active = active & ~((g1.abs() < 1e-5) & (g2.abs() < 1e-5))
    if not bool(active.any()):
      break
    det = h11 * h22 - h21 * h21
    dA = -(h22 * g1 - h21 * g2) / det
    dB = -(-h21 * g1 + h11 * g2) / det
    gd = g1 * dA + g2 * dB
    step = torch.ones(P, dtype=F64, device=dev)
    accepted = ~active
    while True:
      nA, nB = A + step * dA, B + step * dB
      nf = fval(nA, nB)
      ok = ~accepted & (nf < f0 + 1e-4 * step * gd)
      A, B = torch.where(ok, nA, A), torch.where(ok, nB, B)
      f0 = torch.where(ok, nf, f0)
      accepted = accepted | ok
      step = torch.where(accepted, step, step / 2.0)
      failed = ~accepted & (step < 1e-10)
      if bool((accepted | failed).all()):
        break
    active = active & ~failed
  return A, B


def _sigmoid_predict(dec, A, B):
  f = dec * A + B
  return torch.where(f >= 0, torch.exp(-f) / (1.0 + torch.exp(-f)),
                     1.0 / (1.0 + torch.exp(f)))


def multiclass_probability(r: torch.Tensor) -> torch.Tensor:
  """libsvm's ``multiclass_probability`` (Wu, Lin and Weng's second
  method) for n rows at once: r (n, k, k) pairwise probabilities ->
  (n, k); each row iterates until its own stop."""
  n, k, _ = r.shape
  dev = r.device
  eye = torch.eye(k, dtype=torch.bool, device=dev)
  rT = r.transpose(1, 2)  # rT[:, t, j] = r[:, j, t]
  Q = -(rT * r)  # Q[t][j] = -r[j][t]·r[t][j]
  diag = torch.where(eye, torch.zeros_like(r), rT * rT).sum(2)
  Q = torch.where(eye, diag[:, :, None].expand(-1, -1, k), Q)
  p = torch.full((n, k), 1.0 / k, dtype=F64, device=dev)
  eps = 0.005 / k
  active = torch.ones(n, dtype=torch.bool, device=dev)
  for _ in range(max(100, k)):
    Qp = (Q @ p[:, :, None])[:, :, 0]
    pQp = (p * Qp).sum(1)
    err = (Qp - pQp[:, None]).abs().amax(1)
    active = active & ~(err < eps)
    if not bool(active.any()):
      break
    a = active[:, None]
    for t in range(k):
      Qtt = Q[:, t, t]
      diff = (-Qp[:, t] + pQp) / Qtt
      diff = torch.where(active, diff, torch.zeros_like(diff))
      p = p.clone()
      p[:, t] = p[:, t] + diff
      pQp = (pQp + diff * (diff * Qtt + 2 * Qp[:, t])) / (1 + diff) / \
          (1 + diff)
      Qp = (Qp + diff[:, None] * Q[:, t, :]) / (1 + diff)[:, None]
      p = torch.where(a, p / (1 + diff)[:, None], p)
  return p


class SVC:
  """scikit-learn's ``SVC`` (see the module docstring).  Fitted state:
  ``support_vectors_`` (n_SV, d), ``coef_pairs_`` (P, n_SV) — each pair's
  α·y over the support vectors, zero for those of other classes —
  ``rho_`` (P,), ``probA_``/``probB_`` (P,), ``support_`` and
  ``n_support_``; ``dual_coef_`` and ``intercept_`` in scikit-learn's
  layout."""

  def __init__(self, C: float = 1.0, kernel: str = "rbf", degree: int = 3,
               gamma="scale", coef0: float = 0.0, shrinking: bool = True,
               probability: bool = False, tol: float = 1e-3,
               cache_size: float = 200, class_weight=None,
               verbose: bool = False, max_iter: int = -1,
               decision_function_shape: str = "ovr",
               break_ties: bool = False, random_state=None, device=None):
    if class_weight is not None:
      raise NotImplementedError("SVC(class_weight=...) is not ported")
    if break_ties:
      raise NotImplementedError("SVC(break_ties=True) is not ported")
    self.C = float(C)
    self.kernel = kernel
    self.degree = int(degree)
    self.gamma = gamma
    self.coef0 = float(coef0)
    self.shrinking = shrinking
    self.probability = bool(probability)
    self.tol = float(tol)
    self.max_iter = int(max_iter)
    self.decision_function_shape = decision_function_shape
    self.random_state = random_state
    self.device = device

  def _k(self, A, B):
    return _kernel(A, B, self.kernel, self._gamma, self.coef0, self.degree)

  def fit(self, X, y) -> "SVC":
    X = as_tensor(X, device_of(X, device=self.device), F64)
    y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else \
        np.asarray(y)
    self.classes_, yi = np.unique(y.ravel(), return_inverse=True)
    yi = yi.ravel()
    K_cls = len(self.classes_)
    if K_cls < 2:
      raise ValueError("The number of classes has to be greater than one")
    n, d = X.shape
    if self.gamma == "scale":
      var = float(X.var(correction=0))
      self._gamma = 1.0 / (d * var) if var != 0 else 1.0
    elif self.gamma == "auto":
      self._gamma = 1.0 / d
    else:
      self._gamma = float(self.gamma)
    K = self._k(X, X)
    members = [np.flatnonzero(yi == c) for c in range(K_cls)]
    pairs = [(i, j) for i in range(K_cls) for j in range(i + 1, K_cls)]
    problems, folds = [], []
    rng = (self.random_state if isinstance(self.random_state,
                                           np.random.RandomState)
           else np.random.RandomState(self.random_state))
    for (i, j) in pairs:
      rows = np.concatenate([members[i], members[j]])
      lab = np.r_[np.ones(len(members[i])), -np.ones(len(members[j]))]
      problems.append((rows, lab, np.full(len(rows), self.C)))
      if self.probability:
        perm = np.random.RandomState(rng.randint(np.iinfo("i").max)
                                     ).permutation(len(rows))
        l = len(rows)
        for f in range(N_FOLD):
          begin, end = f * l // N_FOLD, (f + 1) * l // N_FOLD
          train = np.r_[perm[:begin], perm[end:]]
          folds.append((len(problems) - 1, perm[begin:end], train))
    # every pair's fold problems with both classes, then the pairs
    fold_problems = [(problems[p][0][tr], problems[p][1][tr],
                      problems[p][2][tr]) for p, _, tr in folds]
    two = [bool((fp[1] > 0).any() and (fp[1] < 0).any())
           for fp in fold_problems]
    solved = _solve_batched(K, [fp for fp, t in zip(fold_problems, two) if t]
                            + problems, self.tol, self.max_iter)
    n_folds = sum(two)
    fold_sol, pair_sol = solved[:n_folds], solved[n_folds:]
    dev = X.device
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    # every pair's variables in one flat vector: rows, labels, α
    rows_cat = np.concatenate([r for r, _, _ in problems])
    lab_cat = np.concatenate([lab for _, lab, _ in problems])
    pair_cat = np.repeat(np.arange(len(pairs)),
                         [len(r) for r, _, _ in problems])
    alpha_cat = torch.cat([a for a, _ in pair_sol])
    # the support vectors: rows with a nonzero α in some pair, by class
    hits = torch.zeros(n, dtype=F64, device=dev).index_add_(
        0, t(rows_cat), (alpha_cat > 0).to(F64))
    nz_h = (hits > 0).cpu().numpy()
    sv = np.concatenate([members[c][nz_h[members[c]]] for c in range(K_cls)])
    self.support_ = sv
    self.n_support_ = np.array([int(nz_h[members[c]].sum())
                                for c in range(K_cls)], np.int32)
    self.support_vectors_ = X[t(sv)]
    pos = np.full(n, -1)
    pos[sv] = np.arange(len(sv))
    keep = pos[rows_cat] >= 0
    coef = torch.zeros(len(pairs), len(sv), dtype=F64, device=dev)
    coef[t(pair_cat[keep]), t(pos[rows_cat][keep])] = (
        alpha_cat * t(lab_cat))[t(keep)]
    self.coef_pairs_ = coef
    self.rho_ = torch.stack([rho for _, rho in pair_sol])
    self._pairs = pairs
    if self.probability:
      self.probA_, self.probB_ = self._platt(
          K, problems, folds, fold_problems, two, fold_sol)
    else:
      self.probA_ = self.probB_ = None
    return self

  def _platt(self, K, problems, folds, fold_problems, two, fold_sol):
    """Each pair's sigmoid from its five folds' decision values, every
    fold at once: (probA, probB), each (P,)."""
    dev = K.device
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    P = len(problems)
    l_max = max(len(r) for r, _, _ in problems)
    dec = torch.zeros(P, l_max, dtype=F64, device=dev)
    solved = [k for k, ok in enumerate(two) if ok]
    if solved:
      # the solved folds padded: (F, L) train rows and α·y, (F, H) held rows
      L = max(len(fold_problems[k][0]) for k in solved)
      H = max(len(folds[k][1]) for k in solved)
      tr = np.zeros((len(solved), L), np.int64)
      held = np.zeros((len(solved), H), np.int64)
      hmask = np.zeros((len(solved), H), bool)
      f_idx, f_pos, a_idx = [], [], []
      for f, k in enumerate(solved):
        rows, y, _ = fold_problems[k]
        tr[f, :len(rows)] = rows
        p, h, _ = folds[k]
        held[f, :len(h)] = problems[p][0][h]
        hmask[f, :len(h)] = True
        f_idx.append(np.full(len(rows), f))
        f_pos.append(np.arange(len(rows)))
        a_idx.append(y)
      ay = torch.zeros(len(solved), L, dtype=F64, device=dev)
      ay[t(np.concatenate(f_idx)), t(np.concatenate(f_pos))] = torch.cat(
          [a for a, _ in fold_sol]) * t(np.concatenate(a_idx))
      rho = torch.stack([r for _, r in fold_sol])
      Kg = K[t(held)[:, :, None], t(tr)[:, None, :]]
      v = (Kg * ay[:, None, :]).sum(2) - rho[:, None]
      pair = np.repeat([folds[k][0] for k in solved], hmask.sum(1))
      at = np.concatenate([folds[k][1] for k in solved])
      dec[t(pair), t(at)] = v[t(hmask)]
    for k, ok in enumerate(two):  # training folds of one class: libsvm's ±1
      if not ok:
        p, h, _ = folds[k]
        dec[p, t(h)] = 1.0 if (fold_problems[k][1] > 0).any() else -1.0
    lengths = t([len(r) for r, _, _ in problems])
    mask = torch.arange(l_max, device=dev)[None] < lengths[:, None]
    labels = torch.zeros(P, l_max, dtype=F64, device=dev)
    labels[mask] = t(np.concatenate([lab for _, lab, _ in problems]))
    return sigmoid_train(dec, labels, mask)

  # -- scikit-learn's layout -----------------------------------------------------
  @property
  def intercept_(self) -> torch.Tensor:
    """``−ρ`` per pair, negated for two classes as scikit-learn shows it."""
    return self.rho_ if len(self.classes_) == 2 else -self.rho_

  @property
  def dual_coef_(self) -> torch.Tensor:
    """(K − 1, n_SV): for pair (i, j), the coefficients of class i's
    support vectors in row j − 1 and class j's in row i (negated for two
    classes, as scikit-learn shows them)."""
    K_cls = len(self.classes_)
    start = np.r_[0, np.cumsum(self.n_support_)]
    out = torch.zeros(K_cls - 1, self.coef_pairs_.shape[1], dtype=F64,
                      device=self.coef_pairs_.device)
    for p, (i, j) in enumerate(self._pairs):
      si, sj = slice(start[i], start[i + 1]), slice(start[j], start[j + 1])
      out[j - 1, si] = self.coef_pairs_[p, si]
      out[i, sj] = self.coef_pairs_[p, sj]
    return -out if K_cls == 2 else out

  # -- prediction ---------------------------------------------------------------
  def _pair_values(self, X) -> torch.Tensor:
    """libsvm's decision values (n, P): positive for the pair's first
    class."""
    X = as_tensor(X, self.support_vectors_.device, F64)
    return self._k(X, self.support_vectors_) @ self.coef_pairs_.T - \
        self.rho_

  def decision_function(self, X) -> torch.Tensor:
    dec = self._pair_values(X)
    K_cls = len(self.classes_)
    if K_cls == 2:
      return -dec[:, 0]
    if self.decision_function_shape == "ovr":
      return _ovr_decision_function(dec < 0, -dec, K_cls)
    return dec

  def _votes(self, dec) -> torch.Tensor:
    K_cls = len(self.classes_)
    votes = torch.zeros(dec.shape[0], K_cls, dtype=torch.long,
                        device=dec.device)
    for p, (i, j) in enumerate(self._pairs):
      win = dec[:, p] > 0
      votes[:, i] += win.long()
      votes[:, j] += (~win).long()
    return votes

  def predict(self, X) -> np.ndarray:
    idx = torch.argmax(self._votes(self._pair_values(X)), dim=1)
    return self.classes_[idx.cpu().numpy()]

  def predict_proba(self, X) -> torch.Tensor:
    if self.probA_ is None:
      raise AttributeError("predict_proba is not available when "
                           "probability=False")
    dec = self._pair_values(X)
    K_cls = len(self.classes_)
    pr = torch.clamp(_sigmoid_predict(dec, self.probA_, self.probB_),
                     MIN_PROB, 1 - MIN_PROB)
    # libsvm couples two classes too (its iteration stops near, not at,
    # the pair's own probability)
    r = torch.zeros(dec.shape[0], K_cls, K_cls, dtype=F64, device=dec.device)
    for p, (i, j) in enumerate(self._pairs):
      r[:, i, j] = pr[:, p]
      r[:, j, i] = 1 - pr[:, p]
    return multiclass_probability(r)

  def predict_log_proba(self, X) -> torch.Tensor:
    return torch.log(self.predict_proba(X))

  def score(self, X, y) -> float:
    y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    return float(np.mean(self.predict(X) == y.ravel()))


def _ovr_decision_function(predictions: torch.Tensor,
                           confidences: torch.Tensor,
                           n_classes: int) -> torch.Tensor:
  """scikit-learn's ``_ovr_decision_function``: one-against-one votes plus
  the summed confidences squashed into (−1/3, 1/3)."""
  n = predictions.shape[0]
  votes = torch.zeros(n, n_classes, dtype=F64, device=predictions.device)
  conf = torch.zeros(n, n_classes, dtype=F64, device=predictions.device)
  k = 0
  for i in range(n_classes):
    for j in range(i + 1, n_classes):
      conf[:, i] -= confidences[:, k]
      conf[:, j] += confidences[:, k]
      votes[:, i] += (predictions[:, k] == 0).to(F64)
      votes[:, j] += (predictions[:, k] == 1).to(F64)
      k += 1
  return votes + conf / (3 * (conf.abs() + 1))


def fast_svc(X, y, *, C: float = 1.0, kernel: str = "linear", **kwargs):
  """``SVC(C, kernel, **kwargs)`` fitted on (X, y)."""
  return SVC(C=C, kernel=kernel, **kwargs).fit(X, y)
