"""Plotting helpers of the port: a copy of the JAX package's
``odin_tpu/visual/__init__.py`` (reference ``odin/visual``): image grids,
spectrograms, heatmaps, DET curves, the multipage ``plot_save``, terminal
(ASCII) plots and the ``Visualizer`` mixin; the extended surface is in
``visual/extended.py``.  Every plotting function takes tensors where JAX's
takes arrays and copies them to the host first (``_host.host_arrays``).
matplotlib is imported lazily, with the Agg backend, when a figure is
drawn: where it is absent (the card's machine), a plot raises the
``ImportError`` that names it, and the text plots still run.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from odin_tpu_torch.visual._host import host_arrays

__all__ = [
    "plot_images", "plot_spectrogram", "plot_heatmap", "plot_det_curve",
    "plot_scatter", "plot_histogram", "plot_save", "print_dist",
    "print_confusion", "print_hist", "Visualizer", "to_axis",
    "plot_series", "plot_confusion_matrix", "plot_comparison_series",
    "plot_animation", "plot_gaussian_mixture", "plot_ellipses",
    "plot_hinton", "plot_multiple_features", "fig2data", "data2fig",
    "plot_figure", "plot_vline", "plot_indices", "plot_colorbar",
    "plot_frame", "plot_close",
    # extended surface (visual/extended.py)
    "plot_series_statistics", "plot_relative_series", "plot_Cnorm",
    "plot_weights", "plot_weights3D", "plot_weights4D",
    "plot_distance_heatmap", "plot_scatter_text", "plot_scatter_layers",
    "plot_histogram_layers", "plot_gridSpec", "plot_gridSubplot",
    "merge_figures", "plot_title", "plot_aspect", "plot_show",
    "plot_save_show", "plot_to_image", "time_ticks", "tile_raster_images",
    "resize_images", "generate_random_colors", "generate_random_colormaps",
    "generate_palette_colors", "generate_random_marker", "check_arg_length",
    "ctext", "print_bar", "print_scatter", "print_hinton", "Animation",
    "plot_comparison_track",
]

_FIGURES: List = []


def _plt():
  import matplotlib
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt
  return plt


@host_arrays
def to_axis(ax=None, figsize=(6, 5)):
  plt = _plt()
  if ax is None:
    _, ax = plt.subplots(figsize=figsize)
  return ax


@host_arrays
def plot_images(images: np.ndarray, grids: Optional[tuple] = None,
                title: Optional[str] = None, ax=None, fig=None):
  """Grid of images (reference ``figures.py:816``)."""
  plt = _plt()
  images = np.asarray(images)
  if images.ndim == 3:
    images = images[..., None]
  n = len(images)
  if grids is None:
    c = int(math.ceil(math.sqrt(n)))
    grids = (int(math.ceil(n / c)), c)
  fig = fig or plt.figure(figsize=(grids[1] * 1.5, grids[0] * 1.5))
  for i in range(n):
    axi = fig.add_subplot(grids[0], grids[1], i + 1)
    img = images[i]
    axi.imshow(img.squeeze(), cmap="gray" if img.shape[-1] == 1 else None)
    axi.axis("off")
  if title:
    fig.suptitle(title)
  _FIGURES.append(fig)
  return fig


@host_arrays
def plot_spectrogram(spec: np.ndarray, sr: int = 16000, hop: int = 160,
                     ax=None, title: Optional[str] = None):
  """Log-spectrogram heatmap (reference ``figures.py:725``)."""
  ax = to_axis(ax)
  spec = np.asarray(spec)
  ax.imshow(spec.T, origin="lower", aspect="auto", cmap="magma",
            extent=[0, len(spec) * hop / sr, 0, spec.shape[1]])
  ax.set_xlabel("time (s)")
  ax.set_ylabel("bins")
  if title:
    ax.set_title(title)
  _FIGURES.append(ax.figure)
  return ax


@host_arrays
def plot_heatmap(mat: np.ndarray, row_labels=None, col_labels=None, ax=None,
                 annotate: bool = False, cmap: str = "RdBu_r", title=None):
  """Annotated heatmap (reference ``heatmap_plot.py``)."""
  ax = to_axis(ax)
  mat = np.asarray(mat)
  vmax = np.abs(mat).max() or 1.0
  im = ax.imshow(mat, cmap=cmap, vmin=-vmax, vmax=vmax, aspect="auto")
  if col_labels is not None:
    ax.set_xticks(range(len(col_labels)))
    ax.set_xticklabels(col_labels, rotation=45, ha="right")
  if row_labels is not None:
    ax.set_yticks(range(len(row_labels)))
    ax.set_yticklabels(row_labels)
  if annotate:
    for i in range(mat.shape[0]):
      for j in range(mat.shape[1]):
        ax.text(j, i, f"{mat[i, j]:.2f}", ha="center", va="center",
                fontsize=7)
  ax.figure.colorbar(im, ax=ax)
  if title:
    ax.set_title(title)
  _FIGURES.append(ax.figure)
  return ax


@host_arrays
def plot_series(series: Union[np.ndarray, Dict[str, np.ndarray]],
                ax=None, smooth: float = 0.0, show_band: bool = True,
                title: Optional[str] = None, xlabel: Optional[str] = None,
                ylabel: Optional[str] = None):
  """Statistical line plot (reference `plot_series`, ``figures.py``).

  Accepts a 1-D series, a (T, K) matrix (mean line + min/max band over K
  runs), or a dict name -> series.  `smooth` in (0, 1) applies EMA
  smoothing with the raw trace ghosted behind (the reference's
  learning-curve style, ``trainer.py:766-844``)."""
  ax = to_axis(ax)

  def _ema(x, a):
    out = np.empty_like(x, dtype=np.float64)
    acc = x[0]
    for i, v in enumerate(x):
      acc = a * acc + (1 - a) * v
      out[i] = acc
    return out

  items = series.items() if isinstance(series, dict) else [(None, series)]
  for name, y in items:
    y = np.asarray(y, np.float64)
    t = np.arange(y.shape[0])
    if y.ndim == 2:
      mean = y.mean(axis=1)
      if show_band:
        ax.fill_between(t, y.min(axis=1), y.max(axis=1), alpha=0.2)
      y = mean
    if smooth > 0:
      (line,) = ax.plot(t, y, alpha=0.25)
      ax.plot(t, _ema(y, smooth), color=line.get_color(), label=name)
    else:
      ax.plot(t, y, label=name)
  if isinstance(series, dict):
    ax.legend(fontsize=8)
  if title:
    ax.set_title(title)
  if xlabel:
    ax.set_xlabel(xlabel)
  if ylabel:
    ax.set_ylabel(ylabel)
  _FIGURES.append(ax.figure)
  return ax


@host_arrays
def plot_comparison_series(runs: Dict[str, Sequence[float]], ax=None,
                           baseline: Optional[str] = None, **kwargs):
  """Multiple named series with an optional dashed baseline run
  (reference multi-run comparison panels)."""
  ax = to_axis(ax)
  for name, y in runs.items():
    style = "--" if name == baseline else "-"
    ax.plot(np.arange(len(y)), np.asarray(y, np.float64), style, label=name)
  ax.legend(fontsize=8)
  for k, v in kwargs.items():
    getattr(ax, f"set_{k}")(v)
  _FIGURES.append(ax.figure)
  return ax


@host_arrays
def plot_confusion_matrix(cm: np.ndarray, labels: Optional[Sequence] = None,
                          ax=None, normalize: bool = True,
                          title: Optional[str] = None):
  """Graphical annotated confusion matrix (reference
  `plot_confusion_matrix`, ``figures.py``)."""
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


@host_arrays
def plot_animation(frames: np.ndarray, path: str, fps: int = 8):
  """Save an image sequence (N, H, W[, C]) as an animated GIF (reference
  animation helpers, ``figures.py``).  Uses matplotlib's Pillow writer —
  no ffmpeg dependency."""
  plt = _plt()
  from matplotlib import animation as _anim
  frames = np.asarray(frames)
  if frames.ndim == 3:
    frames = frames[..., None]
  fig, ax = plt.subplots(figsize=(3, 3))
  ax.axis("off")
  im = ax.imshow(frames[0].squeeze(),
                 cmap="gray" if frames.shape[-1] == 1 else None)

  def _update(i):
    im.set_data(frames[i].squeeze())
    return (im,)

  ani = _anim.FuncAnimation(fig, _update, frames=len(frames), blit=True)
  ani.save(path, writer=_anim.PillowWriter(fps=fps))
  plt.close(fig)
  return path


@host_arrays
def plot_det_curve(Pfa: np.ndarray, Pmiss: np.ndarray, ax=None, label=None):
  """DET curve in normal-deviate scale (reference ``figures.py:1008``)."""
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


@host_arrays
def plot_scatter(x, y=None, color=None, ax=None, title=None, s=8):
  ax = to_axis(ax)
  x = np.asarray(x)
  if y is None and x.ndim == 2:
    x, y = x[:, 0], x[:, 1]
  sc = ax.scatter(x, y, c=color, s=s, cmap="tab10")
  if color is not None:
    ax.figure.colorbar(sc, ax=ax)
  if title:
    ax.set_title(title)
  _FIGURES.append(ax.figure)
  return ax


@host_arrays
def plot_histogram(x, bins: int = 40, ax=None, title=None):
  ax = to_axis(ax)
  ax.hist(np.asarray(x).ravel(), bins=bins)
  if title:
    ax.set_title(title)
  _FIGURES.append(ax.figure)
  return ax


@host_arrays
def plot_ellipses(mean, sigma, color="b", alpha=0.5, ax=None, n_std=2.0):
  """Covariance ellipse(s) for 2-D Gaussian components
  (reference ``figures.py:556``)."""
  from matplotlib.patches import Ellipse
  ax = to_axis(ax)
  mean = np.atleast_2d(np.asarray(mean, np.float64))
  k = len(mean)
  sigma = np.asarray(sigma, np.float64)
  # normalize to one (d, d) covariance per mean row: accepts a diag vector
  # (d,), a batch of diag vectors (k, d), a full cov (d, d) shared across
  # components, or a batch of full covs (k, d, d); when k == d the (k, d)
  # diag-batch reading wins (the GMM overlay use case)
  if sigma.ndim == 1:
    covs = [np.diag(sigma)] * k
  elif sigma.ndim == 2:
    covs = [np.diag(s) for s in sigma] if sigma.shape[0] == k \
        else [sigma] * k
  else:
    covs = list(sigma)
  for mu, cov in zip(mean, covs):
    vals, vecs = np.linalg.eigh(cov[:2, :2])
    angle = math.degrees(math.atan2(vecs[1, -1], vecs[0, -1]))
    w, h = 2.0 * n_std * np.sqrt(np.maximum(vals, 1e-12))
    ax.add_patch(Ellipse(mu[:2], width=w, height=h, angle=angle,
                         facecolor=color, alpha=alpha, edgecolor="k"))
  _FIGURES.append(ax.figure)
  return ax


@host_arrays
def plot_gaussian_mixture(x, means, sigmas, weights=None, ax=None,
                          bins: int = 60, title: Optional[str] = None):
  """Data histogram with the mixture density overlaid (1-D) or a scatter
  with component covariance ellipses (2-D) — reference ``figures.py:438``.

  Accepts raw arrays so it works with `odin_tpu_torch.ml.GMM` (pass
  ``gmm.means_, gmm.covariances_, gmm.weights_``) or any other fit."""
  ax = to_axis(ax)
  x = np.asarray(x, np.float64)
  means = np.atleast_2d(np.asarray(means, np.float64).T).T \
      if np.asarray(means).ndim == 1 else np.asarray(means, np.float64)
  k = len(means)
  weights = np.full(k, 1.0 / k) if weights is None \
      else np.asarray(weights, np.float64)
  sigmas = np.asarray(sigmas, np.float64)
  if x.ndim == 1 or x.shape[1] == 1:
    xf = x.ravel()
    ax.hist(xf, bins=bins, density=True, alpha=0.4, color="gray")
    grid = np.linspace(xf.min(), xf.max(), 400)
    total = np.zeros_like(grid)
    for i in range(k):
      mu = float(np.ravel(means[i])[0])
      var = float(np.ravel(sigmas[i])[0])
      pdf = np.exp(-0.5 * (grid - mu) ** 2 / var) / math.sqrt(
          2 * math.pi * var)
      total += weights[i] * pdf
      ax.plot(grid, weights[i] * pdf, lw=1, alpha=0.8)
    ax.plot(grid, total, "k-", lw=2)
  else:
    ax.scatter(x[:, 0], x[:, 1], s=4, alpha=0.3, color="gray")
    cmap = _plt().get_cmap("tab10")
    for i in range(k):
      plot_ellipses(means[i], sigmas[i], color=cmap(i % 10),
                    alpha=min(0.75, 0.25 + weights[i]), ax=ax)
  if title:
    ax.set_title(title)
  _FIGURES.append(ax.figure)
  return ax


@host_arrays
def plot_hinton(matrix: np.ndarray, max_weight: Optional[float] = None,
                ax=None, title: Optional[str] = None):
  """Hinton diagram: square area = |weight|, color = sign
  (reference ``figures.py:897``)."""
  ax = to_axis(ax)
  matrix = np.asarray(matrix, np.float64)
  if max_weight is None:
    max_weight = 2.0 ** np.ceil(np.log2(np.abs(matrix).max() or 1.0))
  ax.patch.set_facecolor("lightgray")
  ax.set_aspect("equal", "box")
  for (y, x_), w in np.ndenumerate(matrix):
    color = "white" if w > 0 else "black"
    size = min(1.0, np.sqrt(abs(w) / max_weight))
    ax.add_patch(_plt().Rectangle(
        (x_ - size / 2, y - size / 2), size, size,
        facecolor=color, edgecolor=color))
  ax.set_xlim(-1, matrix.shape[1])
  ax.set_ylim(-1, matrix.shape[0])
  ax.invert_yaxis()
  ax.set_xticks([])
  ax.set_yticks([])
  if title:
    ax.set_title(title)
  _FIGURES.append(ax.figure)
  return ax


@host_arrays
def plot_multiple_features(features: Dict[str, np.ndarray],
                           fig=None, title: Optional[str] = None,
                           sr: int = 16000, hop: int = 160):
  """Stacked panels of (T, D) feature matrices sharing the time axis —
  the reference's speech-feature inspection figure (``figures.py:589``,
  used by `FeatureProcessor` validation)."""
  plt = _plt()
  names = [k for k, v in features.items()
           if np.asarray(v).ndim in (1, 2)]
  fig = fig or plt.figure(figsize=(8, 1.8 * len(names)))
  for i, name in enumerate(names):
    ax = fig.add_subplot(len(names), 1, i + 1)
    v = np.asarray(features[name])
    if v.ndim == 1:
      ax.plot(np.arange(len(v)) * hop / sr, v, lw=0.8)
      ax.set_xlim(0, len(v) * hop / sr)
    else:
      ax.imshow(v.T, origin="lower", aspect="auto", cmap="magma",
                extent=[0, len(v) * hop / sr, 0, v.shape[1]])
    ax.set_ylabel(name, fontsize=8)
    if i < len(names) - 1:
      ax.set_xticks([])
  if title:
    fig.suptitle(title)
  _FIGURES.append(fig)
  return fig


@host_arrays
def plot_figure(nrows: int = 8, ncols: int = 8, dpi: int = 120):
  """Open (and register) a new figure sized in reference row/col units
  (reference ``figures.py:254``): height=nrows, width=ncols inches."""
  fig = _plt().figure(figsize=(ncols, nrows), dpi=dpi)
  _FIGURES.append(fig)
  return fig


@host_arrays
def plot_vline(x, ymin: float = 0.0, ymax: float = 1.0, color: str = "r",
               ax=None, **kwargs):
  """Vertical marker line(s) in axis coordinates (reference
  ``figures.py:347``)."""
  ax = to_axis(ax)
  for xi in np.atleast_1d(np.asarray(x, np.float64)):
    ax.axvline(x=xi, ymin=ymin, ymax=ymax, color=color, lw=1,
               alpha=kwargs.pop("alpha", 0.8), **kwargs)
  return ax


@host_arrays
def plot_indices(idx, x=None, ax=None, alpha: float = 0.3,
                 ymin: float = 0.0, ymax: float = 1.0):
  """Highlight selected frame indices (e.g. SAD=speech frames) as vertical
  spans over a signal plot (reference ``figures.py:580``)."""
  ax = to_axis(ax)
  idx = np.asarray(idx)
  if idx.dtype == bool:
    idx = np.nonzero(idx)[0]
  if x is not None:
    ax.plot(np.asarray(x), lw=0.8, color="k")
  for i in idx:
    ax.axvspan(i - 0.5, i + 0.5, ymin=ymin, ymax=ymax, color="orange",
               alpha=alpha, lw=0)
  _FIGURES.append(ax.figure)
  return ax


@host_arrays
def plot_colorbar(colormap: str = "viridis", vmin: float = 0.0,
                  vmax: float = 1.0, ax=None, label: Optional[str] = None,
                  orientation: str = "vertical"):
  """Standalone colorbar attached to an axis (reference
  ``figures.py:1196``)."""
  plt = _plt()
  import matplotlib as mpl
  ax = to_axis(ax)
  norm = mpl.colors.Normalize(vmin=vmin, vmax=vmax)
  sm = mpl.cm.ScalarMappable(norm=norm, cmap=plt.get_cmap(colormap))
  cbar = ax.figure.colorbar(sm, ax=ax, orientation=orientation)
  if label:
    cbar.set_label(label)
  return cbar


@host_arrays
def plot_frame(ax=None, left=None, right=None, top=None, bottom=None):
  """Toggle axis spines (reference ``figures.py:270``); None = unchanged."""
  ax = to_axis(ax)
  for name, val in (("left", left), ("right", right), ("top", top),
                    ("bottom", bottom)):
    if val is not None:
      ax.spines[name].set_visible(bool(val))
  return ax


@host_arrays
def plot_close():
  """Close all figures and clear the pending-save registry (reference
  ``figures.py:1263``)."""
  _plt().close("all")
  _FIGURES.clear()


@host_arrays
def data2fig(data: np.ndarray, ax=None):
  """Show an (H, W, 3|4) uint8 array as an image axis — inverse of
  `fig2data` (reference ``figures.py:248``)."""
  ax = to_axis(ax)
  ax.imshow(np.asarray(data))
  ax.axis("off")
  _FIGURES.append(ax.figure)
  return ax


@host_arrays
def fig2data(fig, dpi: int = 120) -> np.ndarray:
  """Render a figure to an (H, W, 4) uint8 RGBA array (reference
  ``figures.py:238``; feeds TB image logging)."""
  fig.set_dpi(dpi)
  fig.canvas.draw()
  buf = np.asarray(fig.canvas.buffer_rgba())
  return buf.copy()


@host_arrays
def plot_save(path: str = "figures.pdf", figs: Optional[Sequence] = None,
              dpi: int = 120, clear_all: bool = True):
  """Save accumulated figures to a multipage pdf
  (reference ``figures.py:1286``)."""
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


# ---------------------------------------------------------------------------
# terminal (ASCII) plots — reference ``bashplot.py``
# ---------------------------------------------------------------------------
@host_arrays
def print_dist(d: Dict[Any, float], height: int = 10, width: int = 40) -> str:
  """ASCII bar chart of a {label: count} distribution
  (reference ``bashplot.py:196``)."""
  if not d:
    return ""
  keys = list(d.keys())
  vals = np.asarray([d[k] for k in keys], np.float64)
  top = vals.max() or 1.0
  lines = []
  for k, v in zip(keys, vals):
    bar = "#" * int(round(v / top * width))
    lines.append(f"{str(k)[:12]:>12s} | {bar} {v:g}")
  out = "\n".join(lines)
  print(out)
  return out


@host_arrays
def print_hist(x, bins: int = 20, width: int = 40) -> str:
  """ASCII histogram (reference ``bashplot.py:299``)."""
  x = np.asarray(x).ravel()
  counts, edges = np.histogram(x, bins=bins)
  return print_dist({f"{edges[i]:.2f}": c for i, c in enumerate(counts)},
                    width=width)


@host_arrays
def print_confusion(cm: np.ndarray, labels: Optional[Sequence[str]] = None) -> str:
  """ASCII confusion matrix (reference ``bashplot.py``)."""
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


# extended surface — stats/heatmap/scatter/histogram/raster/terminal helpers
# (imported after the core definitions it reuses: _FIGURES, fig2data, ...)
from odin_tpu_torch.visual.extended import (  # noqa: E402
    Animation, check_arg_length, ctext, generate_palette_colors,
    generate_random_colormaps, generate_random_colors,
    generate_random_marker, merge_figures, plot_Cnorm, plot_aspect,
    plot_distance_heatmap, plot_gridSpec, plot_gridSubplot,
    plot_comparison_track, plot_histogram_layers, plot_relative_series,
    plot_save_show,
    plot_scatter_layers, plot_scatter_text, plot_series_statistics,
    plot_show, plot_title, plot_to_image, plot_weights, plot_weights3D,
    plot_weights4D, print_bar, print_hinton, print_scatter, resize_images,
    tile_raster_images, time_ticks,
    get_all_named_colors, plot_detection_curve,
)


class Visualizer:
  """Mixin collecting named figures and saving them at once
  (reference ``visual/base.py``)."""

  def __init__(self):
    self._figures: Dict[str, Any] = {}

  def add_figure(self, name: str, fig) -> "Visualizer":
    if not hasattr(self, "_figures"):
      self._figures = {}
    self._figures[name] = fig
    return self

  def save_figures(self, path: str = "figures.pdf", clear: bool = True):
    figs = list(getattr(self, "_figures", {}).values())
    out = plot_save(path, figs=figs, clear_all=False)
    if clear:
      self._figures = {}
    return out
