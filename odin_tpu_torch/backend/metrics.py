"""Verification metrics and Fréchet distances of the port (PyTorch port of
``odin_tpu/backend/metrics.py``).

The verification metrics (``det_curve``, ``compute_EER``,
``compute_minDCF``, ``compute_AUC``, ``compute_Cnorm``, ``compute_Cavg``,
``:24-171``) take arrays or tensors and return what the JAX package
returns: numpy arrays and floats, the same thresholds, ties grouped the
same way.  ``det_curve`` sorts a tensor's scores on the tensor's own
device and brings back one value per distinct score.  ``roc_curve_``
(``roc_curve``) and ``prc_curve`` are scikit-learn 1.9's ``roc_curve``
(``drop_intermediate=True``, a first threshold of ``inf``) and
``precision_recall_curve`` (``metrics/_ranking.py``), which the JAX package
calls: their scores are sorted on the device of a tensor argument and
their counts are float64.  ``binary_accuracy``, ``categorical_accuracy``,
``confusion_matrix`` (scikit-learn's, as float64, the labels the sorted
union of both arguments when none are given) and ``LER`` (the Levenshtein
distance over the target's length) take arrays or tensors.

For the Fréchet distances (``:174,191``) the feature means and covariances
are computed in float64 on the device of the features; the matrix square
root runs on the host with scipy's ``sqrtm``, as in the JAX package.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "det_curve", "roc_curve_", "roc_curve", "prc_curve", "compute_EER",
    "compute_minDCF", "compute_AUC", "compute_Cnorm", "compute_Cavg",
    "frechet_distance", "frechet_inception_distance", "binary_accuracy",
    "categorical_accuracy", "confusion_matrix", "LER",
]


def _numpy(x, dtype=None) -> np.ndarray:
  """An array or a tensor (on any device) as a numpy array."""
  if isinstance(x, torch.Tensor):
    x = x.detach().cpu().numpy()
  return np.asarray(x, dtype)


def _counts_at_thresholds(pos, y_score):
  """(false positives, true positives, thresholds) at each distinct score
  from the highest down, the counts float64; `pos` marks the positive
  trials.  A tensor's scores are sorted on its device."""
  y_score = (y_score.detach().reshape(-1) if isinstance(y_score, torch.Tensor)
             else torch.from_numpy(np.asarray(y_score).ravel()))
  pos = torch.as_tensor(pos, device=y_score.device)
  # ties are grouped below, so the order inside a group does not matter
  y_score, order = torch.sort(y_score, descending=True, stable=True)
  pos = pos[order].to(torch.float64)
  # the last index of each group of equal scores
  last = torch.nonzero(y_score[1:] != y_score[:-1]).reshape(-1)
  idx = torch.cat([last, last.new_tensor([y_score.numel() - 1])])
  tps = torch.cumsum(pos, 0)[idx]
  fps = 1 + idx.to(torch.float64) - tps
  return _numpy(fps), _numpy(tps), _numpy(y_score[idx])


def det_curve(y_true, y_score, pos_label=None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """False-alarm and miss rates at every distinct score, from the highest
  down: (Pfa, Pmiss, thresholds), rates in [0, 1].  A tensor's scores are
  sorted on its device."""
  y_true = _numpy(y_true).ravel()
  if pos_label is None:
    pos_label = y_true.max()
  pos = y_true == pos_label
  fps, tps, thresholds = _counts_at_thresholds(pos, y_score)
  n_pos = max(int(pos.sum()), 1)
  n_neg = max(int((~pos).sum()), 1)
  Pmiss = 1.0 - tps / n_pos  # miss: target scored below threshold
  Pfa = fps / n_neg          # false alarm: non-target above threshold
  return Pfa, Pmiss, thresholds


def compute_EER(Pfa, Pmiss) -> float:
  """Equal error rate from DET-curve rates: the point where Pfa == Pmiss,
  interpolated linearly around the sign change."""
  Pfa = _numpy(Pfa, np.float64)
  Pmiss = _numpy(Pmiss, np.float64)
  diff = Pmiss - Pfa
  i = np.argmin(np.abs(diff))
  if diff[i] == 0 or i in (0, len(diff) - 1):
    return float((Pfa[i] + Pmiss[i]) / 2)
  j = i + 1 if (diff[i] < 0) == (diff[min(i + 1, len(diff) - 1)] < 0) else i - 1
  i, j = min(i, j), max(i, j)
  if diff[i] * diff[j] > 0:
    return float((Pfa[i] + Pmiss[i]) / 2)
  t = diff[i] / (diff[i] - diff[j])
  return float(Pfa[i] + t * (Pfa[j] - Pfa[i]))


def compute_minDCF(Pfa, Pmiss, Cmiss: float = 1.0, Cfa: float = 1.0,
                   Ptrue: float = 0.5) -> Tuple[float, int]:
  """Minimum detection cost and the index of its threshold."""
  Pfa = _numpy(Pfa, np.float64)
  Pmiss = _numpy(Pmiss, np.float64)
  dcf = Cmiss * Pmiss * Ptrue + Cfa * Pfa * (1.0 - Ptrue)
  i = int(np.argmin(dcf))
  return float(dcf[i]), i


def compute_AUC(x, y, reorder: bool = False) -> float:
  """Area under a curve by the trapezoid rule."""
  x = _numpy(x, np.float64).ravel()
  y = _numpy(y, np.float64).ravel()
  if reorder:
    order = np.argsort(x)
    x, y = x[order], y[order]
  return float(abs(np.sum((x[1:] - x[:-1]) * (y[1:] + y[:-1]) / 2.0)))


def compute_Cnorm(y_true, y_score, Ptrue: float = 0.5, Cfa: float = 1.0,
                  Cmiss: float = 1.0) -> Tuple[float, np.ndarray]:
  """NIST LRE detection cost over an (n, L) log-likelihood matrix with the
  hard decision at log(Ptrue / (1 - Ptrue)): (mean cost, cost per class)."""
  y_true = _numpy(y_true).ravel()
  y_score = _numpy(y_score, np.float64)
  L = y_score.shape[1]
  thr = np.log(Ptrue / (1 - Ptrue))
  costs = np.zeros(L)
  for l in range(L):
    tgt = y_true == l
    non = ~tgt
    Pmiss = np.mean(y_score[tgt, l] < thr) if tgt.any() else 0.0
    Pfa = np.mean(y_score[non, l] >= thr) if non.any() else 0.0
    costs[l] = Cmiss * Ptrue * Pmiss + Cfa * (1 - Ptrue) * Pfa
  return float(costs.mean()), costs


def compute_Cavg(y_llr, y_true,
                 cluster_idx: Optional[Sequence[Sequence[int]]] = None,
                 Ptar: float = 0.5, Cfa: float = 1.0, Cmiss: float = 1.0,
                 probability_based: bool = False) -> Tuple[float, np.ndarray]:
  """Pairwise language-pair average cost over clusters of language ids
  (all ids one cluster by default), threshold log(Ptar / (1 - Ptar)):
  (the least cluster cost, cost per cluster)."""
  y_llr = _numpy(y_llr, np.float64)
  y_true = _numpy(y_true).ravel()
  L = y_llr.shape[1]
  if cluster_idx is None:
    cluster_idx = [list(range(L))]
  thr = np.log(Ptar / (1 - Ptar))
  cluster_cost = np.zeros(len(cluster_idx))
  for c, cluster in enumerate(cluster_idx):
    lang_cost = []
    for lang in cluster:
      tgt = y_true == lang
      if not tgt.any():
        continue
      Pmiss = np.mean(y_llr[tgt, lang] < thr)
      Pfa_sum, n_pairs = 0.0, 0
      for other in cluster:
        if other == lang:
          continue
        imp = y_true == other
        if imp.any():
          Pfa_sum += np.mean(y_llr[imp, lang] >= thr)
          n_pairs += 1
      Pfa = Pfa_sum / max(n_pairs, 1)
      lang_cost.append(Cmiss * Ptar * Pmiss + Cfa * (1 - Ptar) * Pfa)
    cluster_cost[c] = np.mean(lang_cost) if lang_cost else 0.0
  return float(cluster_cost.min()), cluster_cost


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
  """Fréchet distance between two Gaussians (mean, covariance)."""
  from scipy import linalg
  mu1, mu2 = (np.atleast_1d(np.asarray(m, np.float64)) for m in (mu1, mu2))
  sigma1, sigma2 = (np.atleast_2d(np.asarray(s, np.float64))
                    for s in (sigma1, sigma2))
  diff = mu1 - mu2
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")  # sqrtm warns on ill-conditioned input
    covmean = linalg.sqrtm(sigma1 @ sigma2)
  if not np.isfinite(covmean).all():
    offset = np.eye(sigma1.shape[0]) * eps
    covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
  if np.iscomplexobj(covmean):
    covmean = covmean.real
  return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) -
               2 * np.trace(covmean))


def _moments(features):
  """Mean and covariance (ddof 1, as ``np.cov``) in float64 of (N, ...)
  features flattened to (N, F), on the features' device."""
  f = torch.as_tensor(features)
  f = f.reshape(f.shape[0], -1).to(torch.float64)
  return (f.mean(0).cpu().numpy(),
          torch.atleast_2d(torch.cov(f.T)).cpu().numpy())


def frechet_inception_distance(features1, features2) -> float:
  """FID over two sets of pre-extracted feature activations (arrays or
  tensors, (N, ...)); the caller supplies the network (the Gym uses the
  encoder's mean latents when no inception weights are at hand)."""
  mu1, s1 = _moments(features1)
  mu2, s2 = _moments(features2)
  return frechet_distance(mu1, s1, mu2, s2)


def _pos_label(y_true: np.ndarray, pos_label):
  """scikit-learn's ``_check_pos_label_consistency``: 1 where the labels
  lie in {0, 1} or {-1, 1} (or one of them), else `pos_label` is
  required."""
  if pos_label is not None:
    return pos_label
  classes = np.unique(y_true)
  if classes.dtype.kind in "OUS" or len(classes) > 2 or not any(
      np.array_equal(classes, c) for c in
      ([0, 1], [-1, 1], [0], [-1], [1])):
    raise ValueError(f"y_true takes value in {set(classes.tolist())} and "
                     "pos_label is not specified: either make y_true take "
                     "value in {0, 1} or {-1, 1} or pass pos_label "
                     "explicitly.")
  return 1


def _binary_curve(y_true, y_score, pos_label):
  """(fps, tps, thresholds) of scikit-learn's
  ``confusion_matrix_at_thresholds``."""
  y_true = _numpy(y_true).ravel()
  return _counts_at_thresholds(y_true == _pos_label(y_true, pos_label),
                               y_score)


def roc_curve_(y_true, y_score, pos_label=None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """(fpr, tpr, thresholds) of scikit-learn's ``roc_curve`` with
  ``drop_intermediate=True``: the points where neither count bends are
  dropped, (0, 0) is prepended at the threshold ``inf``."""
  fps, tps, thr = _binary_curve(y_true, y_score, pos_label)
  if len(fps) > 2:
    keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                              np.diff(tps, 2)), True])[0]
    fps, tps, thr = fps[keep], tps[keep], thr[keep]
  tps = np.r_[0.0, tps]
  fps = np.r_[0.0, fps]
  thr = np.r_[np.inf, thr.astype(np.float64)]
  if fps[-1] <= 0:
    warnings.warn("No negative samples in y_true, false positive value "
                  "should be meaningless")
    fpr = np.full(fps.shape, np.nan)
  else:
    fpr = fps / fps[-1]
  if tps[-1] <= 0:
    warnings.warn("No positive samples in y_true, true positive value "
                  "should be meaningless")
    tpr = np.full(tps.shape, np.nan)
  else:
    tpr = tps / tps[-1]
  return fpr, tpr, thr


roc_curve = roc_curve_


def prc_curve(y_true, y_probas, pos_label=None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """(precision, recall, thresholds) of scikit-learn's
  ``precision_recall_curve``: recall decreasing, ending at precision 1 and
  recall 0."""
  fps, tps, thr = _binary_curve(y_true, y_probas, pos_label)
  ps = tps + fps
  precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1.0), 0.0)
  if tps[-1] == 0:
    warnings.warn("No positive class found in y_true, recall is set to one "
                  "for all thresholds.")
    recall = np.ones_like(tps)
  else:
    recall = tps / tps[-1]
  return (np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0],
          thr[::-1])


def binary_accuracy(y_true, y_pred, threshold: float = 0.5) -> float:
  """Share of predictions at or above `threshold` that equal the labels,
  the predictions cast to the labels' dtype first."""
  y_true = _numpy(y_true).ravel()
  y_pred = (_numpy(y_pred).ravel() >= threshold).astype(y_true.dtype)
  return float(np.mean(y_true == y_pred))


def categorical_accuracy(y_true, y_pred) -> float:
  """Share of equal classes, one-hot or score rows taken by argmax."""
  y_true = _numpy(y_true)
  y_pred = _numpy(y_pred)
  if y_true.ndim > 1:
    y_true = y_true.argmax(-1)
  if y_pred.ndim > 1:
    y_pred = y_pred.argmax(-1)
  return float(np.mean(y_true == y_pred))


def confusion_matrix(y_true, y_pred, labels=None,
                     normalize: bool = False) -> np.ndarray:
  """Counts of (true, predicted) pairs over `labels` (the sorted union of
  both by default), float64; `normalize` divides each row by its sum."""
  y_true = _numpy(y_true).ravel()
  y_pred = _numpy(y_pred).ravel()
  labels = (np.unique(np.concatenate([y_true, y_pred])) if labels is None
            else np.asarray(labels))
  if labels.size == 0:
    raise ValueError("'labels' should contain at least one label.")
  if y_true.size == 0:
    return np.zeros((labels.size, labels.size), np.float64)
  if not np.isin(y_true, labels).any():
    raise ValueError("At least one label specified must be in y_true")
  order = np.argsort(labels, kind="mergesort")
  sorted_labels = labels[order]
  n = labels.size

  def index(y):
    pos = np.clip(np.searchsorted(sorted_labels, y), 0, n - 1)
    found = sorted_labels[pos] == y
    return np.where(found, order[pos], n)

  ti, pi = index(y_true), index(y_pred)
  keep = (ti < n) & (pi < n)
  cm = np.zeros((n, n), np.float64)
  np.add.at(cm, (ti[keep], pi[keep]), 1.0)
  if normalize:
    cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1e-12)
  return cm


def _levenshtein(s1: Sequence, s2: Sequence) -> int:
  if len(s1) < len(s2):
    s1, s2 = s2, s1
  prev = list(range(len(s2) + 1))
  for i, c1 in enumerate(s1):
    curr = [i + 1]
    for j, c2 in enumerate(s2):
      curr.append(min(prev[j + 1] + 1, curr[j] + 1, prev[j] + (c1 != c2)))
    prev = curr
  return prev[-1]


def LER(y_true, y_pred, return_mean: bool = True):
  """Label error rate: the Levenshtein distance of each prediction from
  its target over the target's length (at least 1); their mean, or the
  list."""
  rates = [_levenshtein(list(_numpy(t).ravel()) if isinstance(
      t, torch.Tensor) else t, list(_numpy(p).ravel()) if isinstance(
          p, torch.Tensor) else p) / max(len(t), 1)
           for t, p in zip(y_true, y_pred)]
  return float(np.mean(rates)) if return_mean else rates
