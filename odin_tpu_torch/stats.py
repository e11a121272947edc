"""Statistics helpers of the port (a copy of ``odin_tpu/stats.py``, host
NumPy): data splits, frequency counts, summaries, reservoir sampling,
dispersion and sparsity, class weights, discrete KL, and the
classification report and diagnosis.  ``classification_report`` is built
from the port's own metrics, since scikit-learn is not among the port's
dependencies."""
from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["train_valid_test_split", "freqcount", "describe", "summary",
           "sampling_iter"]


def train_valid_test_split(x: Sequence,
                           train: float = 0.6,
                           valid: Optional[float] = None,
                           inc_test: bool = True,
                           idfunc: Optional[Callable] = None,
                           seed: int = 1):
  """Split a sequence into train/valid(/test) partitions
  (reference ``stats.py:103``).  With `idfunc`, items sharing an id stay in
  the same partition (speaker-disjoint splits)."""
  x = list(x)
  rng = np.random.RandomState(seed)
  if idfunc is not None:
    groups: Dict[Any, list] = {}
    for item in x:
      groups.setdefault(idfunc(item), []).append(item)
    keys = list(groups.keys())
    rng.shuffle(keys)
    units: Sequence = keys
  else:
    units = list(range(len(x)))
    rng.shuffle(units)
  n = len(units)
  n_train = int(round(train * n))
  if valid is None:
    valid = (1.0 - train) / (2 if inc_test else 1)
  n_valid = int(round(valid * n))

  def gather(sel):
    if idfunc is None:
      return [x[i] for i in sel]
    return [item for k in sel for item in groups[k]]

  train_set = gather(units[:n_train])
  valid_set = gather(units[n_train:n_train + n_valid])
  if not inc_test:
    return train_set, valid_set
  test_set = gather(units[n_train + n_valid:])
  return train_set, valid_set, test_set


def freqcount(x: Iterable, key: Optional[Callable] = None,
              sorting: Optional[str] = None) -> Dict[Any, int]:
  """Frequency count dict (reference `freqcount`)."""
  counts = Counter(key(i) if key else i for i in x)
  if sorting == "asc":
    return dict(sorted(counts.items(), key=lambda kv: kv[1]))
  if sorting in ("desc", "dsc"):
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))
  return dict(counts)


def describe(x, shorten: bool = False) -> str:
  """Stats summary string (reference ``stats.py:476``)."""
  x = np.asarray(x)
  stats = dict(shape=tuple(x.shape), dtype=str(x.dtype),
               min=float(np.min(x)), max=float(np.max(x)),
               mean=float(np.mean(x)), std=float(np.std(x)),
               median=float(np.median(x)),
               n_nan=int(np.isnan(x).sum()) if x.dtype.kind == "f" else 0)
  if shorten:
    return (f"[{stats['shape']}|{stats['dtype']}] "
            f"{stats['min']:.3g}..{stats['max']:.3g} "
            f"mu={stats['mean']:.3g} sd={stats['std']:.3g}")
  return "\n".join(f"{k:>8s}: {v}" for k, v in stats.items())


summary = describe


def sampling_iter(it: Iterable, k: int, seed: int = 1) -> list:
  """Reservoir sampling of k items from an iterable of unknown length
  (reference ``stats.py:263``)."""
  rng = np.random.RandomState(seed)
  reservoir: list = []
  for i, item in enumerate(it):
    if i < k:
      reservoir.append(item)
    else:
      j = rng.randint(0, i + 1)
      if j < k:
        reservoir[j] = item
  return reservoir


def is_discrete(x) -> bool:
  """All values integral (reference ``stats.py:164``)."""
  x = np.asarray(x)
  return bool(np.all(x == x.astype(np.int64)))


def is_binary(x) -> bool:
  """Only {0, 1} values (reference ``stats.py:174``)."""
  u = np.unique(np.asarray(x))
  return bool(np.all(np.isin(u, (0, 1))))


def sparsity_percentage(x, batch_size: int = 1024) -> float:
  """Fraction of zero entries, streamed in batches
  (reference ``stats.py:360``)."""
  n_zeros, n_total = 0, int(np.prod(x.shape))
  for start in range(0, x.shape[0], batch_size):
    y = x[start:start + batch_size]
    nnz = (y.count_nonzero() if hasattr(y, "count_nonzero")
           else np.count_nonzero(y))
    n_zeros += int(np.prod(y.shape)) - int(nnz)
  return n_zeros / n_total


def logVMR(x, axis=None, logged_values: bool = False):
  """log(1 + variance-to-mean ratio) — index of dispersion (0 for
  constant, 1 for Poisson, >1 over-dispersed; reference ``stats.py:373``)."""
  x = np.asarray(x)
  if logged_values:
    x = np.expm1(x)
  return np.log1p(np.var(x, axis=axis) / np.mean(x, axis=axis))


def prior2weights(prior, exponential: bool = False, min_value: float = 0.1,
                  max_value=None, norm: bool = False) -> np.ndarray:
  """Class priors -> inverse-frequency class weights
  (reference ``stats.py:16``): highest-prior class gets weight ~1, rarer
  classes proportionally more; optional [min, max] rescaling and
  normalization; zero-prior classes get weight 0."""
  prior = np.asarray(prior, np.float64).ravel()
  prior = prior / prior.sum()
  zero_ids = np.where(prior == 0)[0]
  nz = prior[prior > 0]
  w_nz = (1.0 / nz) * nz.max()
  if exponential:
    w_nz = w_nz ** 2
  if min_value is not None and max_value is not None:
    lo, hi = float(min_value), float(max_value)
    rng = w_nz.max() - w_nz.min()
    w_nz = lo if rng == 0 else (hi - lo) * (w_nz - w_nz.min()) / rng + lo
  if norm:
    w_nz = w_nz / w_nz.sum()
  out = np.zeros_like(prior)
  out[prior > 0] = w_nz
  out[zero_ids] = 0.0
  return out


__all__ += ["is_discrete", "is_binary", "sparsity_percentage", "logVMR",
            "prior2weights"]


def KL_divergence(P, Q) -> float:
  """Discrete KL(P||Q) between two count/probability vectors or mappings
  (reference ``stats.py:240``)."""
  from collections.abc import Mapping
  if isinstance(P, Mapping) and isinstance(Q, Mapping):
    keys = sorted(set(P) | set(Q))
    P = [P.get(k, 0) for k in keys]
    Q = [Q.get(k, 0) for k in keys]
  P = np.asarray(P, np.float64)
  Q = np.asarray(Q, np.float64)
  P = P / P.sum()
  Q = Q / Q.sum()
  mask = P > 0
  return float(np.sum(P[mask] * np.log(P[mask] / np.maximum(Q[mask], 1e-12))))


def _report_table(y_true, y_pred, names, digits: int = 2) -> str:
  """scikit-learn's ``classification_report`` text for integer labels
  ``0..len(names)-1`` with ``zero_division=0``, computed from the port's
  confusion matrix (``backend.metrics``): per class precision
  tp / predicted, recall tp / true, F1 2 tp / (true + predicted) and
  support; then the accuracy row (the micro average, where every label
  seen is among the names) or the micro average row, and the macro and
  support-weighted averages."""
  from odin_tpu_torch.backend.metrics import confusion_matrix
  idx = np.arange(len(names))
  cm = confusion_matrix(y_true, y_pred, labels=idx)
  tp, pred, true = np.diag(cm), cm.sum(0), cm.sum(1)

  def divide(num, den):
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    return np.where(den == 0, 0.0, num / np.where(den == 0, 1.0, den))

  p, r, f1 = divide(tp, pred), divide(tp, true), divide(2 * tp, true + pred)
  support = true.astype(np.int64)
  width = max(max(len(n) for n in names), len("weighted avg"), digits)
  headers = ["precision", "recall", "f1-score", "support"]
  report = ("{:>{width}s} " + " {:>9}" * 4).format("", *headers,
                                                   width=width) + "\n\n"
  row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
  for row in zip(names, p, r, f1, support):
    report += row_fmt.format(*row, width=width, digits=digits)
  report += "\n"
  seen = set(np.unique(np.concatenate([np.ravel(y_true),
                                       np.ravel(y_pred)])).tolist())
  total = int(support.sum())
  micro = [float(v) for v in (divide(tp.sum(), pred.sum()),
                              divide(tp.sum(), true.sum()),
                              divide(2 * tp.sum(), true.sum() + pred.sum()))]
  if seen <= set(idx.tolist()):
    report += ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}" +
               " {:>9}\n").format("accuracy", "", "", micro[2], total,
                                  width=width, digits=digits)
  else:
    report += row_fmt.format("micro avg", *micro, total, width=width,
                             digits=digits)
  weights = true / true.sum() if true.sum() else np.zeros_like(p)
  report += row_fmt.format("macro avg", p.mean(), r.mean(), f1.mean(), total,
                           width=width, digits=digits)
  report += row_fmt.format("weighted avg", *(float(np.sum(v * weights))
                                             for v in (p, r, f1)), total,
                           width=width, digits=digits)
  return report


def classification_report(y_pred, y_true, labels) -> str:
  """Accuracy, the per-class report and the confusion matrix as one
  string, in scikit-learn's layout (which the JAX package prints), from
  the port's own metrics: no scikit-learn is needed."""
  from odin_tpu_torch.backend.metrics import (categorical_accuracy,
                                              confusion_matrix)
  labels = list(labels)
  names = [str(i) for i in labels]
  y_pred = np.asarray(y_pred)
  y_true = np.asarray(y_true)
  if y_pred.ndim == 2:
    y_pred = y_pred.argmax(-1)
  if y_true.ndim == 2:
    y_true = y_true.argmax(-1)
  acc = categorical_accuracy(y_true, y_pred)
  report = _report_table(y_true, y_pred, names)
  cm = confusion_matrix(y_true, y_pred,
                        labels=np.arange(len(labels))).astype(np.int64)
  return (f"Accuracy: {acc:.4f}\n{report}\nConfusion matrix:\n{cm}")


def classification_diagnose(X, y_true, y_pred, num_samples: int = 8,
                            seed: int = 1234):
  """Most-frequent confusion pairs -> example samples (reference
  ``stats.py:397``): OrderedDict (true, pred) -> [samples from X], sorted
  by confusion frequency; correct predictions excluded."""
  from collections import OrderedDict
  rng = np.random.RandomState(seed)
  y_true = np.asarray(y_true)
  y_pred = np.asarray(y_pred)
  if y_true.ndim == 2:
    y_true = y_true.argmax(-1)
  if y_pred.ndim == 2:
    y_pred = y_pred.argmax(-1)
  pairs = {}
  for i, (t, p) in enumerate(zip(y_true, y_pred)):
    if t != p:
      pairs.setdefault((int(t), int(p)), []).append(i)
  out = OrderedDict()
  for key in sorted(pairs, key=lambda k: -len(pairs[k])):
    idx = pairs[key]
    take = rng.choice(idx, size=min(num_samples, len(idx)), replace=False)
    out[key] = [X[i] for i in take]
  return out


__all__ += ["KL_divergence", "classification_report",
            "classification_diagnose"]
