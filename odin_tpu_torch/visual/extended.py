"""``plot_Cnorm`` and ``plot_detection_curve`` (a copy of
``odin_tpu/visual/extended.py``'s), host-only matplotlib code."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["plot_Cnorm", "plot_detection_curve"]


def _register(fig):
  from odin_tpu_torch.visual import _FIGURES
  _FIGURES.append(fig)


def to_axis(ax=None, figsize=(6, 5)):
  from odin_tpu_torch.visual import _plt
  if ax is not None:
    return ax
  return _plt().figure(figsize=figsize).add_subplot(111)


def plot_Cnorm(cnorm: np.ndarray, labels: Sequence, Ptrue=(0.1, 0.5),
               ax=None, title: Optional[str] = None, fontsize: int = 12):
  """Normalised detection-cost matrix: a row per operating prior in
  `Ptrue`, a column per class (pairs with ``backend.metrics.
  compute_Cnorm``)."""
  ax = to_axis(ax, figsize=(max(4, len(labels) * 0.6), 2.5))
  cnorm = np.atleast_2d(np.asarray(cnorm, np.float64))
  Ptrue = [float(p) for p in np.atleast_1d(Ptrue)]
  if len(Ptrue) != cnorm.shape[0]:
    raise ValueError(f"cnorm has {cnorm.shape[0]} rows but "
                     f"{len(Ptrue)} Ptrue values given")
  ax.imshow(cnorm, interpolation="nearest", cmap="Blues", aspect="auto")
  ax.set_xticks(range(len(labels)))
  ax.set_xticklabels([str(l) for l in labels], rotation=-57,
                     fontsize=fontsize)
  ax.set_yticks(range(len(Ptrue)))
  ax.set_yticklabels([str(p) for p in Ptrue], fontsize=fontsize)
  ax.set_ylabel("Ptrue", fontsize=fontsize)
  ax.set_xlabel("predicted label", fontsize=fontsize)
  for i in range(cnorm.shape[0]):
    for j in range(cnorm.shape[1]):
      ax.text(j, i, f"{cnorm[i, j]:.2f}", color="red", fontsize=fontsize,
              ha="center", va="center")
  ax.grid(False)
  mean = float(cnorm.mean())
  ax.set_title(f"Cnorm: {mean:.6f}" if title is None
               else f"{title} (Cnorm: {mean:.6f})",
               fontsize=fontsize + 2, weight="semibold")
  _register(ax.figure)
  return ax


def plot_detection_curve(x, y, curve: str = "det", ax=None, label=None,
                         **kwargs):
  """DET (normal-deviate Pfa/Pmiss), ROC (fpr/tpr) or PRC
  (recall/precision) axes over the same two arrays, by `curve`."""
  from odin_tpu_torch.visual import _plt, plot_det_curve
  curve = str(curve).lower()
  if curve == "det":
    return plot_det_curve(x, y, ax=ax, label=label)
  ax = ax or _plt().gca()
  ax.plot(x, y, label=label, **kwargs)
  if curve == "roc":
    ax.plot([0, 1], [0, 1], "k--", lw=0.8)
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
  elif curve == "prc":
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
  else:
    raise ValueError(f"unknown curve type: {curve}")
  if label:
    ax.legend()
  return ax
