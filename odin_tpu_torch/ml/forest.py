"""scikit-learn 1.9's ``RandomForestClassifier`` carried in torch, on the
device of its input (``sklearn/ensemble/_forest.py``,
``sklearn/tree/_splitter.pyx``, ``_criterion.pyx``, ``_tree.pyx``), at
the defaults of the JAX package's ``fast_rf_classifier``: Gini impurity,
``max_features='sqrt'``, grown until pure, bootstrap.

As scikit-learn: X is cast to float32; each tree's seed is one
``randint(MAX_INT)`` of the forest's ``RandomState``; its bootstrap is
``RandomState(seed).randint(0, n, n)``, applied as integer sample
weights (rows drawn no time are left out of the tree); its splitter's
``rand_r`` state is the first ``randint(0, RAND_R_MAX)`` of another
``RandomState(seed)``, and the features each node visits are replayed
draw for draw (``bay/vi/estimators.SplitterDrawsBatch``, at most
``max_features`` draws a node unless all were constant) in the
depth-first order in which scikit-learn grows a tree; a node is a leaf
below ``min_samples_split`` rows or at impurity <= ``EPSILON``; the split
maximises ``−w_R·gini_R − w_L·gini_L`` over the visited features and the
gaps between adjacent values more than ``FEATURE_THRESHOLD`` apart,
computed expression for expression from the integer class weights (so
every gain is the same number on every device, and ties resolve as
scikit-learn's do: the first best in visit order, then in position); the
threshold is the midpoint of the two values; ``predict_proba`` is the
mean over the trees of each leaf's class fractions.

All trees grow at once, one node of each tree a step, each tree in its
own depth-first order: a step finds the node's rows, its class weights
and its constant features on the device, replays the visit on the host,
and searches every visited feature's split in one pass over the
presorted rows (the Gini sums from prefix sums of the class weights, the
running count of each row's own class from one more presorted order).

The forest has its own grower beside the boosted trees'
(``GradientBoostingClassifier._grow``), because the two differ at every
step a shared one would take: that one walks a fixed heap of depth 3,
node h of all of a stage's trees at once, on unweighted rows, with the
squared-sum gain of integer residuals and Newton leaf values; a forest's
trees take shapes of their own (grown until pure, about 1,300 nodes at
1,536 rows), so each keeps its own stack, on bootstrap weights, with
Gini gains and class-count leaves.  They share the draws' replay
(``SplitterDrawsBatch``) and scikit-learn's constants.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from odin_tpu_torch.device import as_tensor, device_of

__all__ = ["RandomForestClassifier", "fast_rf_classifier"]

F64 = torch.float64
MAX_INT = np.iinfo(np.int32).max


def _max_features(max_features, d: int) -> int:
  if max_features == "sqrt":
    return max(1, int(np.sqrt(d)))
  if max_features == "log2":
    return max(1, int(np.log2(d)))
  if max_features is None:
    return d
  if isinstance(max_features, float):
    return max(1, int(max_features * d))
  return int(max_features)


class RandomForestClassifier:
  """scikit-learn's ``RandomForestClassifier`` (see the module docstring).
  Fitted state: ``classes_`` and, per tree t and node (the order in which
  nodes were made), ``feature_[t]``, ``threshold_[t]``, ``left_[t]``,
  ``right_[t]`` (−1 at a leaf) and ``value_[t]`` (the node's weighted
  class counts at leaves), padded to the largest tree."""

  def __init__(self, n_estimators: int = 100, *, criterion: str = "gini",
               max_depth: Optional[int] = None, min_samples_split: int = 2,
               min_samples_leaf: int = 1, max_features="sqrt",
               bootstrap: bool = True, random_state=None, n_jobs=None,
               device=None, **kwargs):
    if criterion != "gini" or kwargs:
      raise NotImplementedError(
          f"RandomForestClassifier options criterion={criterion!r} "
          f"{sorted(kwargs)} are not ported")
    self.n_estimators = int(n_estimators)
    self.criterion = criterion
    self.max_depth = max_depth
    self.min_samples_split = int(min_samples_split)
    self.min_samples_leaf = int(min_samples_leaf)
    self.max_features = max_features
    self.bootstrap = bool(bootstrap)
    self.random_state = random_state
    self.device = device

  def fit(self, X, y) -> "RandomForestClassifier":
    # the trees' shared parts live with the boosted trees (imported here:
    # the bay.vi package imports much of the port)
    from odin_tpu_torch.bay.vi.estimators import (
        EPSILON, FEATURE_THRESHOLD, RAND_R_MAX, SplitterDrawsBatch)
    X = as_tensor(X, device_of(X, device=self.device), torch.float32)
    dev = X.device
    y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else \
        np.asarray(y)
    self.classes_, yi = np.unique(y.ravel(), return_inverse=True)
    yi = yi.ravel()
    n, d = X.shape
    C = len(self.classes_)
    T = self.n_estimators
    self.n_features_in_ = d
    mf = _max_features(self.max_features, d)
    rng = (self.random_state if isinstance(self.random_state,
                                           np.random.RandomState)
           else np.random.RandomState(self.random_state))
    seeds = [rng.randint(MAX_INT) for _ in range(T)]
    weights = np.ones((T, n))
    if self.bootstrap:
      for t, s in enumerate(seeds):
        idx = np.random.RandomState(s).randint(0, n, n, dtype=np.int32)
        weights[t] = np.bincount(idx, minlength=n)
    draws = SplitterDrawsBatch([np.random.RandomState(s).randint(
        0, RAND_R_MAX) for s in seeds], d)
    w = torch.from_numpy(weights).to(dev)
    yt = torch.from_numpy(yi).to(dev)
    onehot = torch.nn.functional.one_hot(yt, C).to(F64)
    XT64 = X.T.to(F64).contiguous()  # (d, n), float32 values
    order = torch.argsort(X.T, dim=1, stable=True)  # (d, n)
    x_sorted = XT64.gather(1, order)
    x_pad = torch.cat([x_sorted, x_sorted[:, -1:]], 1)
    cls_sorted = yt[order]  # (d, n)
    # each feature's positions sorted by class (stable), and the first
    # position of each one's class run in that order
    by_class = torch.argsort(cls_sorted * n + torch.arange(n, device=dev),
                             dim=1)
    cls_by = cls_sorted.gather(1, by_class)
    pos = torch.arange(n, device=dev)
    new_run = torch.cat([torch.ones_like(cls_by[:, :1], dtype=torch.bool),
                         cls_by[:, 1:] != cls_by[:, :-1]], 1)
    run_start = torch.cummax(torch.where(new_run, pos, 0), 1).values
    # the trees, by node key (the order in which nodes were made)
    cap = 2 * n + 1
    feature = np.zeros((T, cap), np.int64)
    threshold = np.zeros((T, cap))
    left = np.full((T, cap), -1, np.int64)
    right = np.full((T, cap), -1, np.int64)
    n_keys = np.ones(T, np.int64)
    node_of = torch.zeros(T, n, dtype=torch.long, device=dev)
    stacks = [[(0, 0, 0)] for _ in range(T)]  # (key, depth, n_constant)
    depth_max = 0
    max_depth = math.inf if self.max_depth is None else self.max_depth
    while True:
      act = [t for t in range(T) if stacks[t]]
      if not act:
        break
      recs = [stacks[t].pop() for t in act]
      A = torch.tensor(act, device=dev)
      key = torch.tensor([r[0] for r in recs], device=dev)
      depth = np.array([r[1] for r in recs])
      in_node = (node_of[A] == key[:, None]) & (w[A] > 0)
      wn = w[A] * in_node
      tot = wn @ onehot  # (a, C)
      W = tot.sum(1)
      sq_tot = (tot * tot).sum(1)
      n_rows = in_node.sum(1)
      impurity = 1.0 - sq_tot / (W * W)
      leaf = ((n_rows < self.min_samples_split) |
              (n_rows < 2 * self.min_samples_leaf) | (impurity <= EPSILON))
      leaf_h = leaf.cpu().numpy() | (depth >= max_depth)
      split = np.flatnonzero(~leaf_h)
      if len(split) == 0:
        continue
      # each splitting node's constant features, from its rows alone
      S = torch.from_numpy(split).to(dev)
      t_idx, r_idx = torch.nonzero(in_node[S], as_tuple=True)
      vals = XT64[:, r_idx].T  # (rows, d)
      inf = torch.full((len(split), d), math.inf, dtype=F64, device=dev)
      t_idx = t_idx[:, None].expand(-1, d)
      lo = inf.scatter_reduce(0, t_idx, vals, "amin")
      hi = (-inf).scatter_reduce(0, t_idx, vals, "amax")
      constant = (hi <= lo + FEATURE_THRESHOLD).cpu().numpy()
      visited, n_visited, n_totals = draws.visit(
          [act[k] for k in split], [recs[k][2] for k in split], constant, mf)
      F = max(1, int(n_visited.max()))
      feats = visited[:, :F]
      rank = np.where(np.arange(F)[None] < n_visited[:, None],
                      np.arange(F)[None], F + 1)
      found, fbest, thr = self._search(
          torch.from_numpy(np.ascontiguousarray(feats)).to(dev),
          torch.from_numpy(rank).to(dev),
          wn[S], tot[S], sq_tot[S], W[S], n_rows[S], order, x_sorted, x_pad,
          cls_sorted, by_class, run_start)
      found_h = found.cpu().numpy()
      fbest_h, thr_h = fbest.cpu().numpy(), thr.cpu().numpy()
      go = torch.zeros(len(act), dtype=torch.bool, device=dev)
      go[S] = found
      kl = torch.zeros(len(act), dtype=torch.long, device=dev)
      fsel = torch.zeros(len(act), dtype=torch.long, device=dev)
      tsel = torch.zeros(len(act), dtype=F64, device=dev)
      for a, k in enumerate(split):
        if not found_h[a]:
          continue
        t = act[k]
        kk, dep = recs[k][0], recs[k][1]
        feature[t, kk], threshold[t, kk] = fbest_h[a], thr_h[a]
        left[t, kk], right[t, kk] = n_keys[t], n_keys[t] + 1
        n_keys[t] += 2
        n_total = int(n_totals[a])
        # the right child is pushed first, so the left one is grown first
        stacks[t].append((right[t, kk], dep + 1, n_total))
        stacks[t].append((left[t, kk], dep + 1, n_total))
        depth_max = max(depth_max, dep + 1)
      kl[S] = torch.from_numpy(np.array([left[act[k], recs[k][0]]
                                         for k in split])).to(dev)
      fsel[S] = fbest
      tsel[S] = thr
      x = XT64.gather(0, fsel[:, None].expand(-1, n))
      child = torch.where(x <= tsel[:, None], kl[:, None], kl[:, None] + 1)
      move = in_node & go[:, None]
      node_of[A] = torch.where(move, child, node_of[A])
    K = int(n_keys.max())
    self.feature_ = torch.from_numpy(feature[:, :K]).to(dev)
    self.threshold_ = torch.from_numpy(threshold[:, :K]).to(dev)
    self.left_ = torch.from_numpy(left[:, :K]).to(dev)
    self.right_ = torch.from_numpy(right[:, :K]).to(dev)
    flat = (torch.arange(T, device=dev)[:, None] * K + node_of).reshape(-1)
    value = torch.zeros(T * K, C, dtype=F64, device=dev).index_add_(
        0, flat, (w[:, :, None] * onehot[None]).reshape(-1, C))
    self.value_ = value.reshape(T, K, C)
    self.depth_ = depth_max
    self.n_nodes_ = n_keys
    return self

  def _search(self, feats, rank, wn, tot, sq_tot, W, n_rows, order,
              x_sorted, x_pad, cls_sorted, by_class, run_start):
    """The best split of each node over its visited features `feats`
    (a, F), the first best in visit order `rank`: (found, feature,
    threshold), each (a,)."""
    from odin_tpu_torch.bay.vi.estimators import FEATURE_THRESHOLD
    a, F = feats.shape
    n = order.shape[1]
    dev = feats.device
    ords = order[feats]  # (a, F, n) rows in each feature's order
    wf = wn.gather(1, ords.reshape(a, -1)).reshape(a, F, n)
    m = wf > 0
    # the weight of the node's earlier rows of each row's own class
    q = by_class[feats]
    wq = wf.gather(2, q)
    excl = torch.cumsum(wq, 2) - wq
    before = excl - excl.gather(2, run_start[feats])
    clb = torch.zeros_like(wf).scatter(2, q, before)
    tot_row = tot.gather(1, cls_sorted[feats].reshape(a, -1)).reshape(a, F, n)
    wl = torch.cumsum(wf, 2)
    sql = torch.cumsum(2.0 * clb * wf + wf * wf, 2)
    crossl = torch.cumsum(wf * tot_row, 2)
    sqr = sq_tot[:, None, None] - 2.0 * crossl + sql
    wr = W[:, None, None] - wl
    nl = torch.cumsum(m.to(torch.long), 2)
    nr = n_rows[:, None, None] - nl
    pos = torch.arange(n, device=dev)
    idx = torch.where(m, pos, n)
    nxt = torch.flip(torch.cummin(torch.flip(idx, [2]), 2).values, [2])
    nxt = torch.cat([nxt[:, :, 1:], torch.full_like(nxt[:, :, :1], n)], 2)
    xs = x_sorted[feats]
    x_next = x_pad[feats].gather(2, nxt)
    msl = self.min_samples_leaf
    ok = (m & (nxt < n) & (x_next > xs + FEATURE_THRESHOLD) &
          (nl >= msl) & (nr >= msl) & (rank[:, :, None] <= F))
    # scikit-learn's Gini proxy, -w_R·gini_R - w_L·gini_L, as it writes it
    gini_l = 1.0 - sql / (wl * wl)
    gini_r = 1.0 - sqr / (wr * wr)
    proxy = torch.where(ok, -wr * gini_r - wl * gini_l,
                        torch.full_like(wl, -math.inf))
    best_f = proxy.amax(2)
    best = best_f.amax(1)
    tie = torch.where(best_f == best[:, None], rank, torch.full_like(rank,
                                                                     F + 2))
    j = torch.argmin(tie, 1)
    row = proxy.gather(1, j[:, None, None].expand(a, 1, n))[:, 0]
    p = torch.argmax((row == best[:, None]).to(torch.int32), 1)
    x_lo = xs.gather(1, j[:, None, None].expand(a, 1, n))[:, 0].gather(
        1, p[:, None])[:, 0]
    x_hi = x_next.gather(1, j[:, None, None].expand(a, 1, n))[:, 0].gather(
        1, p[:, None])[:, 0]
    thr = x_lo / 2.0 + x_hi / 2.0
    thr = torch.where((thr == x_hi) | torch.isinf(thr), x_lo, thr)
    found = torch.isfinite(best)
    return found, feats.gather(1, j[:, None])[:, 0], thr

  # -- prediction ---------------------------------------------------------------
  def apply(self, X) -> torch.Tensor:
    """The leaf (node key) of each row in each tree, (T, m)."""
    dev = self.feature_.device
    XT64 = as_tensor(X, dev, torch.float32).T.to(F64)
    T = self.feature_.shape[0]
    node = torch.zeros(T, XT64.shape[1], dtype=torch.long, device=dev)
    for _ in range(self.depth_):
      lft = self.left_.gather(1, node)
      x = XT64.gather(0, self.feature_.gather(1, node))
      nxt = torch.where(x <= self.threshold_.gather(1, node), lft,
                        self.right_.gather(1, node))
      node = torch.where(lft >= 0, nxt, node)
    return node

  def predict_proba(self, X) -> torch.Tensor:
    leaf = self.apply(X)
    T, m = leaf.shape
    C = self.value_.shape[2]
    v = self.value_.gather(1, leaf[:, :, None].expand(T, m, C))
    s = v.sum(2, keepdim=True)
    v = v / torch.where(s == 0, torch.ones_like(s), s)
    out = v[0].clone()
    for t in range(1, T):  # scikit-learn's order of the sum
      out += v[t]
    return out / T

  def predict(self, X) -> np.ndarray:
    return self.classes_[torch.argmax(self.predict_proba(X), 1).cpu().numpy()]

  def score(self, X, y) -> float:
    y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    return float(np.mean(self.predict(X) == y.ravel()))


def fast_rf_classifier(X, y, *, n_estimators: int = 100,
                       random_state: int = 1, **kwargs):
  """``RandomForestClassifier(n_estimators, random_state, **kwargs)``
  fitted on (X, y)."""
  return RandomForestClassifier(n_estimators=n_estimators,
                                random_state=random_state, **kwargs).fit(X, y)
