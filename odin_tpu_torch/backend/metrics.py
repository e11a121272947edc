"""Verification metrics and Fréchet distances of the port (PyTorch port of
``odin_tpu/backend/metrics.py``).

The verification metrics (``det_curve``, ``compute_EER``,
``compute_minDCF``, ``compute_AUC``, ``compute_Cnorm``, ``compute_Cavg``,
``:24-171``) take arrays or tensors and return what the JAX package
returns: numpy arrays and floats, the same thresholds, ties grouped the
same way.  ``det_curve`` sorts a tensor's scores on the tensor's own
device and brings back one value per distinct score.  ``roc_curve`` and
``prc_curve`` wrap scikit-learn in the JAX package and are not ported yet
(ROADMAP.md queue 1, item 6).

For the Fréchet distances (``:174,191``) the feature means and covariances
are computed in float64 on the device of the features; the matrix square
root runs on the host with scipy's ``sqrtm``, as in the JAX package.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["det_curve", "compute_EER", "compute_minDCF", "compute_AUC",
           "compute_Cnorm", "compute_Cavg", "frechet_distance",
           "frechet_inception_distance"]


def _numpy(x, dtype=None) -> np.ndarray:
  """An array or a tensor (on any device) as a numpy array."""
  if isinstance(x, torch.Tensor):
    x = x.detach().cpu().numpy()
  return np.asarray(x, dtype)


def det_curve(y_true, y_score, pos_label=None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """False-alarm and miss rates at every distinct score, from the highest
  down: (Pfa, Pmiss, thresholds), rates in [0, 1].  A tensor's scores are
  sorted on its device."""
  y_score = (y_score.detach().reshape(-1) if isinstance(y_score, torch.Tensor)
             else torch.from_numpy(np.asarray(y_score).ravel()))
  y_true = torch.as_tensor(_numpy(y_true).ravel(), device=y_score.device)
  if pos_label is None:
    pos_label = y_true.max()
  pos = y_true == pos_label
  # ties are grouped below, so the order inside a group does not matter
  y_score, order = torch.sort(y_score, descending=True, stable=True)
  pos = pos[order]
  # thresholds at distinct score values: the last index of each group
  last = torch.nonzero(y_score[1:] != y_score[:-1]).reshape(-1)
  idx = torch.cat([last, last.new_tensor([y_score.numel() - 1])])
  # the counts come to the host, whose numpy divides them as JAX's does
  # (a CUDA division by a scalar multiplies by its reciprocal)
  tps = _numpy(torch.cumsum(pos, 0)[idx]).astype(np.float64)
  idx_h = _numpy(idx)
  fps = (1 + idx_h - tps).astype(np.float64)
  n_pos = max(int(pos.sum()), 1)
  n_neg = max(int((~pos).sum()), 1)
  Pmiss = 1.0 - tps / n_pos  # miss: target scored below threshold
  Pfa = fps / n_neg          # false alarm: non-target above threshold
  return Pfa, Pmiss, _numpy(y_score[idx])


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
