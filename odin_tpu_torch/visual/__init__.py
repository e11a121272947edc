"""The plotting helpers that ``ml.evaluate`` needs (a copy of
``odin_tpu/visual``'s ``plot_confusion_matrix``, ``plot_det_curve``,
``plot_save`` and ``print_confusion``; ``plot_Cnorm`` and
``plot_detection_curve`` are in ``visual/extended.py``).  Host-only
matplotlib code, imported lazily with the Agg backend so that a headless
run never fails; the rest of ``odin_tpu.visual`` is ROADMAP.md queue 1,
item 8."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["plot_confusion_matrix", "plot_det_curve", "plot_save",
           "print_confusion", "to_axis", "plot_Cnorm",
           "plot_detection_curve"]

_FIGURES: List = []


def _plt():
  import matplotlib
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt
  return plt


def to_axis(ax=None, figsize=(6, 5)):
  plt = _plt()
  if ax is None:
    _, ax = plt.subplots(figsize=figsize)
  return ax


def plot_confusion_matrix(cm: np.ndarray, labels: Optional[Sequence] = None,
                          ax=None, normalize: bool = True,
                          title: Optional[str] = None):
  """Annotated confusion matrix, each row normalised to its sum unless
  `normalize` is false."""
  ax = to_axis(ax)
  cm = np.asarray(cm, np.float64)
  shown = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1e-12) \
      if normalize else cm
  im = ax.imshow(shown, cmap="Blues", vmin=0.0,
                 vmax=shown.max() if not normalize else 1.0)
  n = cm.shape[0]
  labels = labels if labels is not None else [str(i) for i in range(n)]
  ax.set_xticks(range(n))
  ax.set_xticklabels(labels, rotation=45, ha="right")
  ax.set_yticks(range(n))
  ax.set_yticklabels(labels)
  thresh = shown.max() / 2.0
  for i in range(n):
    for j in range(cm.shape[1]):
      txt = f"{shown[i, j]:.2f}" if normalize else f"{cm[i, j]:.0f}"
      ax.text(j, i, txt, ha="center", va="center", fontsize=7,
              color="white" if shown[i, j] > thresh else "black")
  ax.set_ylabel("true")
  ax.set_xlabel("predicted")
  ax.figure.colorbar(im, ax=ax)
  if title:
    ax.set_title(title)
  _FIGURES.append(ax.figure)
  return ax


def plot_det_curve(Pfa: np.ndarray, Pmiss: np.ndarray, ax=None, label=None):
  """DET curve on normal-deviate axes."""
  from scipy.stats import norm
  ax = to_axis(ax)
  eps = 1e-6
  x = norm.ppf(np.clip(Pfa, eps, 1 - eps))
  y = norm.ppf(np.clip(Pmiss, eps, 1 - eps))
  ax.plot(x, y, label=label)
  ticks = np.array([0.001, 0.01, 0.05, 0.2, 0.5])
  ax.set_xticks(norm.ppf(ticks))
  ax.set_xticklabels([f"{t:g}" for t in ticks])
  ax.set_yticks(norm.ppf(ticks))
  ax.set_yticklabels([f"{t:g}" for t in ticks])
  ax.set_xlabel("false alarm rate")
  ax.set_ylabel("miss rate")
  if label:
    ax.legend()
  _FIGURES.append(ax.figure)
  return ax


def plot_save(path: str = "figures.pdf", figs: Optional[Sequence] = None,
              dpi: int = 120, clear_all: bool = True):
  """Save `figs` (the figures drawn so far by default) to a multipage
  PDF."""
  plt = _plt()
  from matplotlib.backends.backend_pdf import PdfPages
  figs = list(figs) if figs is not None else list(dict.fromkeys(_FIGURES))
  with PdfPages(path) as pdf:
    for fig in figs:
      pdf.savefig(fig, dpi=dpi)
  if clear_all:
    for fig in figs:
      plt.close(fig)
    _FIGURES.clear()
  return path


def print_confusion(cm: np.ndarray,
                    labels: Optional[Sequence[str]] = None) -> str:
  """ASCII confusion matrix, printed and returned."""
  cm = np.asarray(cm)
  labels = labels or [str(i) for i in range(cm.shape[0])]
  w = max(max(len(str(l)) for l in labels), 6)
  header = " " * w + " " + " ".join(f"{l:>{w}s}" for l in labels)
  lines = [header]
  for i, l in enumerate(labels):
    row = " ".join(f"{cm[i, j]:>{w}.2g}" for j in range(cm.shape[1]))
    lines.append(f"{l:>{w}s} {row}")
  out = "\n".join(lines)
  print(out)
  return out


from odin_tpu_torch.visual.extended import (  # noqa: E402
    plot_Cnorm, plot_detection_curve)
