"""Vector normalisation and cosine scoring of the port (PyTorch port of
``odin_tpu/ml/scoring.py``).

``compute_class_avg``, ``compute_within_cov`` and ``compute_wccn`` run in
float64 on the device of their tensor argument (the card for arrays unless
`device` says otherwise); ``VectorNormalizer`` (centering -> unit length ->
WCCN -> unit length) and ``Scorer``'s cosine path run in float64 on their
`device` and keep their state and results there.  Class labels stay numpy,
in ``np.unique`` order.

Not ported yet, each raising: ``VectorNormalizer(lda=True)``
(scikit-learn's ``LinearDiscriminantAnalysis``) and
``Scorer(method="svm")`` (``SVC`` with Platt probabilities), ROADMAP.md
queue 1, item 6.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from odin_tpu_torch.device import resolve_device
from odin_tpu_torch.ml.gmm_tmat import _numpy, _on

__all__ = ["compute_within_cov", "compute_class_avg", "compute_wccn",
           "VectorNormalizer", "Scorer"]

F64 = torch.float64


def _not_ported(what: str) -> NotImplementedError:
  return NotImplementedError(
      f"{what} is not ported yet: it needs scikit-learn's estimator carried "
      "in torch (ROADMAP.md queue 1, item 6)")


def _device_of(X, device=None) -> torch.device:
  """`device` if given, else X's device if X is a tensor, else the card."""
  if device is not None:
    return resolve_device(device)
  if isinstance(X, torch.Tensor):
    return X.device
  return resolve_device("cuda")


def _labels(y) -> np.ndarray:
  return _numpy(y).ravel()


def _unit(X: torch.Tensor) -> torch.Tensor:
  return X / torch.clamp(torch.linalg.norm(X, dim=1, keepdim=True),
                         min=1e-12)


def _class_index(y) -> Tuple[np.ndarray, np.ndarray]:
  classes, idx = np.unique(_labels(y), return_inverse=True)
  return classes, idx.ravel()


def compute_class_avg(X, y, device=None) -> Tuple[np.ndarray, torch.Tensor]:
  """(classes in ``np.unique`` order, (K, D) float64 class means)."""
  dev = _device_of(X, device)
  X = _on(X, dev, F64)
  classes, idx = _class_index(y)
  idx = torch.from_numpy(idx).to(dev)
  sums = torch.zeros((len(classes), X.shape[1]), dtype=F64,
                     device=dev).index_add_(0, idx, X)
  counts = torch.bincount(idx, minlength=len(classes)).to(F64)
  return classes, sums / counts[:, None]


def compute_within_cov(X, y, device=None) -> torch.Tensor:
  """Within-class covariance (D, D), float64."""
  dev = _device_of(X, device)
  X = _on(X, dev, F64)
  _, means = compute_class_avg(X, y)
  idx = torch.from_numpy(_class_index(y)[1]).to(dev)
  Xc = X - means[idx]
  return (Xc.T @ Xc) / len(X)


def compute_wccn(X, y, epsilon: float = 1e-6, device=None) -> torch.Tensor:
  """The WCCN projection: the Cholesky factor of the inverse within-class
  covariance (plus `epsilon`·I), float64."""
  W = compute_within_cov(X, y, device)
  W = W + epsilon * torch.eye(W.shape[0], dtype=F64, device=W.device)
  return torch.linalg.cholesky(torch.linalg.inv(W))


class VectorNormalizer:
  """Centering -> unit length -> WCCN -> unit length, in float64 on
  `device`; ``mean`` and ``W`` are tensors there."""

  def __init__(self, centering: bool = True, wccn: bool = False,
               unit_length: bool = True, lda: bool = False,
               concat: bool = False,
               device: Union[str, torch.device] = "cuda"):
    if lda:
      raise _not_ported("VectorNormalizer(lda=True)")
    self.centering = bool(centering)
    self.wccn = bool(wccn)
    self.unit_length = bool(unit_length)
    self.concat = bool(concat)
    self.device = resolve_device(device)
    self.mean: Optional[torch.Tensor] = None
    self.W: Optional[torch.Tensor] = None

  def fit(self, X, y=None) -> "VectorNormalizer":
    X = _on(X, self.device, F64)
    self.mean = X.mean(0)
    if self.wccn and y is not None:
      Xc = X - self.mean
      if self.unit_length:
        Xc = _unit(Xc)
      self.W = compute_wccn(Xc, y)
    return self

  def transform(self, X) -> torch.Tensor:
    X = _on(X, self.device, F64)
    if self.centering and self.mean is not None:
      X = X - self.mean
    if self.unit_length:
      X = _unit(X)
    if self.W is not None:
      X = X @ self.W
      if self.unit_length:
        X = _unit(X)
    return X

  def fit_transform(self, X, y=None) -> torch.Tensor:
    return self.fit(X, y).transform(X)


class Scorer:
  """Cosine scoring of test vectors against the enrolled class means, on
  `device` (reference ``scoring.py:252``)."""

  def __init__(self, method: str = "cosine", labels=None,
               wccn: bool = True, lda: bool = False, centering: bool = True,
               device: Union[str, torch.device] = "cuda"):
    if method == "svm":
      raise _not_ported("Scorer(method='svm')")
    if method != "cosine":
      raise ValueError(f"method must be 'cosine' or 'svm', given {method!r}")
    self.method = method
    self.normalizer = VectorNormalizer(centering=centering, wccn=wccn,
                                       lda=lda, unit_length=True,
                                       device=device)
    self.device = self.normalizer.device
    self.labels = labels
    self.enroll: Optional[torch.Tensor] = None

  def fit(self, X, y) -> "Scorer":
    y = _labels(y)
    Xn = self.normalizer.fit(X, y).transform(X)
    self.labels, self.enroll = compute_class_avg(Xn, y)
    return self

  def score(self, X) -> torch.Tensor:
    """(n_test, n_classes) cosine scores, float64."""
    return _unit(self.normalizer.transform(X)) @ _unit(self.enroll).T

  def predict_proba(self, X) -> torch.Tensor:
    return torch.softmax(self.score(X), dim=1)

  def predict(self, X) -> np.ndarray:
    return self.labels[_numpy(torch.argmax(self.score(X), dim=1))]
