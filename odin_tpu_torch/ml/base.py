"""Classifier evaluation of the port (PyTorch port of
``odin_tpu/ml/base.py``): ``evaluate`` and the ``Evaluable`` mixin.

``evaluate`` turns the scores into log-likelihood ratios with
``backend.maths.to_llr`` on the device of the scores (the card for an
array unless `device` says otherwise) and returns the JAX package's dict
(``log_loss``, ``accuracy``, ``Cnorm``, ``EER``, ``minDCF``,
``confusion_matrix``), prints the same log and, given `path`, writes the
same four-page PDF (confusion matrix, C_norm, the micro DET and ROC
curves) on the host.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from odin_tpu_torch.device import as_tensor, device_of

__all__ = ["evaluate", "Evaluable"]


def _host(x) -> np.ndarray:
  return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
      np.asarray(x)


def _as_label_indices(y) -> np.ndarray:
  y = _host(y)
  if y.ndim == 2:  # one-hot -> indices
    y = np.argmax(y, axis=-1)
  return y.astype(int)


def evaluate(y_true, y_pred_proba=None, y_pred_log_proba=None,
             labels: Optional[Sequence[str]] = None, title: str = "",
             path: Optional[str] = None, print_log: bool = True,
             device=None) -> dict:
  """Score a classifier's probabilities (or log-probabilities): the dict
  {log_loss, accuracy, Cnorm, EER, minDCF, confusion_matrix}; the DET
  curve pools the one-against-the-rest trials of every class."""
  from odin_tpu_torch.backend.maths import to_llr
  from odin_tpu_torch.backend.metrics import (compute_Cnorm, compute_EER,
                                              compute_minDCF, det_curve,
                                              roc_curve)
  from odin_tpu_torch.visual import print_confusion

  if y_pred_proba is None and y_pred_log_proba is None:
    raise ValueError("At least one of `y_pred_proba` or `y_pred_log_proba` "
                     "must not be None")
  scores = y_pred_proba if y_pred_log_proba is None else y_pred_log_proba
  dev = device_of(scores, device=device)
  y_llr_t = to_llr(as_tensor(scores, dev))
  n_classes = y_llr_t.shape[1]
  y_true = _as_label_indices(y_true)
  y_llr = _host(y_llr_t)
  y_pred = np.argmax(y_llr, axis=-1)
  if labels is None:
    labels = [str(i) for i in range(n_classes)]

  if y_pred_proba is not None:
    p = torch.clamp(as_tensor(y_pred_proba, dev, torch.float64), 1e-12, 1.0)
    p = p / p.sum(-1, keepdim=True)
    rows = torch.as_tensor(y_true, device=dev)
    ll = float(-torch.mean(torch.log(
        p[torch.arange(len(y_true), device=dev), rows])))
  else:
    ll = float("nan")
  acc = float(np.mean(y_pred == y_true))
  cm = np.zeros((n_classes, n_classes), np.int64)
  np.add.at(cm, (y_true, y_pred), 1)
  cnorm, cnorm_arr = compute_Cnorm(y_true, y_llr)
  onehot = np.eye(n_classes)[y_true]
  Pfa, Pmiss, _ = det_curve(onehot.ravel(), y_llr_t.reshape(-1))
  eer = compute_EER(Pfa, Pmiss)
  mindcf = compute_minDCF(Pfa, Pmiss)[0]
  out = dict(log_loss=ll, accuracy=acc, Cnorm=float(np.mean(cnorm)),
             EER=float(eer), minDCF=float(mindcf), confusion_matrix=cm)

  if print_log:
    print("--------", title)
    print(f"Log loss : {ll:.4f}")
    print(f"Accuracy : {acc:.4f}")
    print(f"C_norm   : {np.mean(cnorm):.4f}")
    print(f"EER      : {eer:.4f}")
    print(f"minDCF   : {mindcf:.4f}")
    print(print_confusion(cm, labels))

  if path is not None:
    from odin_tpu_torch.visual import (_plt, plot_Cnorm, plot_confusion_matrix,
                                       plot_detection_curve, plot_save)
    plt = _plt()
    figs = []
    fig = plt.figure(figsize=(max(4, n_classes), max(4, n_classes) + 1))
    plot_confusion_matrix(cm, labels)
    figs.append(fig)
    fig = plt.figure(figsize=(max(4, n_classes) + 1, 3))
    plot_Cnorm(np.atleast_2d(cnorm_arr), labels, Ptrue=(0.5,))
    figs.append(fig)
    fig = plt.figure()
    plot_detection_curve(Pfa, Pmiss, curve="det")
    plt.title(f"DET micro {title}")
    figs.append(fig)
    fpr, tpr, _ = roc_curve(onehot.ravel(), y_llr_t.reshape(-1))
    fig = plt.figure()
    plot_detection_curve(fpr, tpr, curve="roc")
    plt.title(f"ROC micro {title}")
    figs.append(fig)
    plot_save(path, figs=figs)
  return out


class Evaluable:
  """Mixin: an estimator with `labels` and ``predict_proba`` (or
  ``predict_log_proba``) gains ``evaluate(X, y)``."""

  @property
  def labels(self):
    raise NotImplementedError

  def evaluate(self, X, y, labels=None, title="", path=None,
               print_log: bool = True):
    if labels is None:
      try:
        labels = self.labels
      except NotImplementedError:
        labels = None
    proba = self.predict_proba(X) if hasattr(self, "predict_proba") else None
    if hasattr(self, "predict_log_proba"):
      log_proba = self.predict_log_proba(X)
    elif proba is not None:
      p = as_tensor(proba)
      log_proba = torch.log(torch.clamp(p, 1e-12, 1.0))
    else:
      raise ValueError(
          f'Class "{type(self).__name__}" must have `predict_proba` or '
          "`predict_log_proba`")
    self.last_evaluation_ = evaluate(
        y_true=y, y_pred_proba=proba, y_pred_log_proba=log_proba,
        labels=labels, title=title, path=path, print_log=print_log)
    return self
