"""The extended plotting surface of the port: a copy of the JAX package's
``odin_tpu/visual/extended.py`` (reference ``odin/visual``'s
``stats_plot.py``, ``heatmap_plot.py``, ``scatter_plot.py``,
``histogram_plot.py``, ``plot_utils.py``, ``bashplot.py`` and
``animation.py``): statistical series plots, weight panels, Cnorm and
distance heatmaps, layered scatters and histograms, raster tiling,
palettes, terminal plots and the ``Animation`` GIF builder.  Tensors are
copied to the host first (``_host.host_arrays``); matplotlib is imported
lazily with the Agg backend.
"""
from __future__ import annotations

import colorsys
import math
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from odin_tpu_torch.visual._host import host_arrays

__all__ = [
    "to_axis",
    "check_arg_length",
    "generate_random_colors",
    "generate_random_colormaps",
    "generate_palette_colors",
    "generate_random_marker",
    "tile_raster_images",
    "resize_images",
    "plot_series_statistics",
    "plot_relative_series",
    "plot_comparison_track",
    "plot_Cnorm",
    "plot_weights",
    "plot_weights3D",
    "plot_weights4D",
    "plot_distance_heatmap",
    "plot_scatter_text",
    "plot_scatter_layers",
    "plot_histogram_layers",
    "plot_gridSpec",
    "plot_gridSubplot",
    "merge_figures",
    "plot_title",
    "plot_aspect",
    "plot_show",
    "plot_save_show",
    "plot_to_image",
    "time_ticks",
    "ctext",
    "print_bar",
    "print_scatter",
    "print_hinton",
    "Animation",
    "get_all_named_colors",
    "plot_detection_curve",
]


def _plt():
  import matplotlib
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt
  return plt


def _register(fig):
  from odin_tpu_torch.visual import _FIGURES
  _FIGURES.append(fig)


@host_arrays
def to_axis(ax=None, figsize=(6, 5), is_3D: bool = False):
  """Axis coercion that can also mint 3-D axes (reference
  ``plot_utils.py`` `to_axis`/`to_axis2D`)."""
  plt = _plt()
  if ax is not None:
    return ax
  fig = plt.figure(figsize=figsize)
  if is_3D:
    from mpl_toolkits.mplot3d import Axes3D  # noqa: F401 (registers proj)
    ax = fig.add_subplot(111, projection="3d")
  else:
    ax = fig.add_subplot(111)
  return ax


@host_arrays
def check_arg_length(dat, n: int, default=None, converter=None) -> list:
  """Broadcast a scalar-or-sequence argument to exactly `n` entries
  (reference ``plot_utils.py`` `check_arg_length`)."""
  if dat is None:
    out = [default] * n
  elif isinstance(dat, (list, tuple, np.ndarray)):
    out = list(dat)
    if len(out) == 1:
      out = out * n
    if len(out) != n:
      raise ValueError(f"need {n} values, got {len(out)}")
  else:
    out = [dat] * n
  if converter is not None:
    out = [default if v is None else converter(v) for v in out]
  return out


# ---------------------------------------------------------------------------
# palettes — reference ``plot_utils.py:53``
# ---------------------------------------------------------------------------
@host_arrays
def generate_random_colors(n: int, seed: int = 1234,
                           lightness_value: Optional[float] = None,
                           return_hsl: bool = False,
                           return_hex: bool = True) -> list:
  """`n` maximally hue-separated random colors (reference
  ``plot_utils.py:53``): evenly spaced hues, jittered saturation/lightness."""
  rand = np.random.RandomState(seed)
  out = []
  for hue in np.linspace(0.0, 0.88, num=int(n)):
    sat = 0.6 + rand.rand() / 2.5
    light = (0.25 + rand.rand() / 1.4 if lightness_value is None
             else float(lightness_value))
    if return_hsl:
      out.append((hue, sat, light))
      continue
    rgb = colorsys.hls_to_rgb(hue, light, sat)
    out.append("#%02x%02x%02x" % tuple(int(c * 255) for c in rgb)
               if return_hex else rgb)
  return out


@host_arrays
def generate_random_colormaps(n: int, seed: int = 1234,
                              bicolors: bool = False) -> list:
  """`n` random single- (or bi-) hue LinearSegmentedColormaps (reference
  ``plot_utils.py:81``)."""
  from matplotlib.colors import LinearSegmentedColormap

  def _ramp(h, s, light):
    # light -> base -> dark stops of the same hue
    stops = [(h, min(light + 0.49, 0.98), s), (h, light, s),
             (h, max(light - 0.1, 0.02), min(s + 0.1, 1.0))]
    return [colorsys.hls_to_rgb(hh, ll, ss) for hh, ll, ss in stops]

  base = generate_random_colors(n * (2 if bicolors else 1), seed=seed,
                                lightness_value=0.5, return_hsl=True)
  maps = []
  for i in range(n):
    colors = (_ramp(*base[n + i])[::-1] + _ramp(*base[i]) if bicolors
              else _ramp(*base[i]))
    maps.append(LinearSegmentedColormap.from_list(f"Colormap{i}", colors))
  return maps


@host_arrays
def generate_palette_colors(n: int, palette: str = "tab20") -> list:
  """`n` colors cycled from a named matplotlib palette (reference
  ``plot_utils.py`` `generate_palette_colors`)."""
  cmap = _plt().get_cmap(palette)
  k = getattr(cmap, "N", 256)
  return [cmap(i % k) for i in range(int(n))]


_MARKERS = "o^sDvPXp*h<>Hd8"


@host_arrays
def generate_random_marker(n: int, seed: int = 1234) -> list:
  """`n` distinct matplotlib marker glyphs (reference ``plot_utils.py``)."""
  if n > len(_MARKERS):
    rand = np.random.RandomState(seed)
    return [
        _MARKERS[i % len(_MARKERS)]
        for i in rand.permutation(n)
    ]
  return list(_MARKERS[:n])


# ---------------------------------------------------------------------------
# raster utilities — reference ``plot_utils.py:189``
# ---------------------------------------------------------------------------
@host_arrays
def tile_raster_images(X: np.ndarray, images_per_row: Optional[int] = None,
                       v_pad: float = 0.01, h_pad: float = 0.01
                       ) -> np.ndarray:
  """Tile a batch of images into one raster array (reference
  ``plot_utils.py:189``).  Accepts (N,H,W), (N,H,W,1) or (N,H,W,C); pads
  between tiles with the max intensity (gray) or zeros (color)."""
  X = np.asarray(X)
  if X.ndim == 4 and X.shape[-1] == 1:
    X = X[..., 0]
  if X.ndim == 2:
    X = X[None]
  if X.ndim not in (3, 4):
    raise ValueError(f"unsupported image batch shape {X.shape}")
  n, h, w = X.shape[:3]
  pad_h = int(math.ceil(h_pad * h))
  pad_w = int(math.ceil(v_pad * w))
  fill = (255.0 if X.max() > 1 else 1.0) if X.ndim == 3 else 0.0
  cols = images_per_row or int(math.ceil(math.sqrt(n)))
  rows = int(math.ceil(n / cols))
  chan = () if X.ndim == 3 else (X.shape[-1],)
  out = np.full((rows * (h + pad_h) - pad_h, cols * (w + pad_w) - pad_w)
                + chan, fill, dtype=X.dtype)
  for i in range(n):
    r, c = divmod(i, cols)
    out[r * (h + pad_h):r * (h + pad_h) + h,
        c * (w + pad_w):c * (w + pad_w) + w] = X[i]
  return out


@host_arrays
def resize_images(X: np.ndarray, shape) -> np.ndarray:
  """Nearest-neighbor batch resize to (H, W) — dependency-free counterpart
  of the reference's PIL-based `resize_images` (``plot_utils.py``)."""
  X = np.asarray(X)
  single = X.ndim in (2, 3) and (X.ndim == 2 or X.shape[-1] in (1, 3, 4))
  if X.ndim == 2:
    X = X[None, ..., None]
  elif X.ndim == 3 and X.shape[-1] in (1, 3, 4):
    X = X[None]
  elif X.ndim == 3:
    X = X[..., None]
  H, W = int(shape[0]), int(shape[1])
  rows = (np.arange(H) * X.shape[1] / H).astype(np.int64)
  cols = (np.arange(W) * X.shape[2] / W).astype(np.int64)
  out = X[:, rows][:, :, cols]
  return out[0] if single else out


# ---------------------------------------------------------------------------
# statistical series — reference ``stats_plot.py:79,263``
# ---------------------------------------------------------------------------
@host_arrays
def plot_series_statistics(observed=None, expected=None, total_stdev=None,
                           explained_stdev=None, ax=None,
                           color_set: str = "Set2", sort_by="expected",
                           sort_ascending: bool = True,
                           xscale: str = "linear", yscale: str = "linear",
                           xlabel: str = "feature", ylabel: str = "value",
                           y_cutoff: Optional[float] = None,
                           legend_enable: bool = True,
                           legend_title: Optional[str] = None,
                           alpha: Optional[float] = None,
                           fontsize: int = 8, title: Optional[str] = None,
                           return_handles: bool = False,
                           return_indices: bool = False):
  """Observed-vs-expected series with total/explained-stdev bands, sorted
  by one of the series (reference ``stats_plot.py:79`` — the count-model
  posterior-predictive diagnostic).

  `observed` is drawn as points, `expected` as a line; `total_stdev` /
  `explained_stdev` (scalar or per-point) become +/-1,2 sigma bands around
  `expected`."""
  plt = _plt()
  ax = to_axis(ax, figsize=(8, 4))
  observed = None if observed is None else np.asarray(observed,
                                                      np.float64).ravel()
  expected = None if expected is None else np.asarray(expected,
                                                      np.float64).ravel()
  base = expected if sort_by == "expected" else observed
  if base is None:
    base = observed if observed is not None else expected
  order = np.argsort(base)
  if not sort_ascending:
    order = order[::-1]
  n = len(base)
  t = np.arange(n)
  cmap = plt.get_cmap(color_set)
  a = 0.8 if alpha is None else float(alpha)
  handles = []

  def _band(stdev, color, label):
    if stdev is None or expected is None:
      return
    s = np.asarray(stdev, np.float64)
    s = np.full(n, float(s)) if s.ndim == 0 else s.ravel()[order]
    mu = expected[order]
    for k, aa in ((2.0, 0.15 * a), (1.0, 0.3 * a)):
      h = ax.fill_between(t, mu - k * s, mu + k * s, color=color, alpha=aa,
                          lw=0, label=label if k == 1.0 else None)
    handles.append(h)

  _band(total_stdev, cmap(2), "total stdev")
  _band(explained_stdev, cmap(3), "explained stdev")
  if expected is not None:
    (h,) = ax.plot(t, expected[order], color=cmap(1), lw=1.2,
                   label="expected", alpha=a)
    handles.append(h)
  if observed is not None:
    h = ax.scatter(t, observed[order], s=3, color=cmap(0), alpha=a,
                   label="observed")
    handles.append(h)
  ax.set_xscale(xscale)
  ax.set_yscale(yscale)
  if y_cutoff is not None:
    ax.set_ylim(top=float(y_cutoff))
  ax.set_xlabel(xlabel, fontsize=fontsize)
  ax.set_ylabel(ylabel, fontsize=fontsize)
  ax.spines["top"].set_visible(False)
  ax.spines["right"].set_visible(False)
  if legend_enable and handles:
    ax.legend(fontsize=fontsize, title=legend_title, loc="best")
  if title:
    ax.set_title(title, fontsize=fontsize + 2)
  _register(ax.figure)
  out = (ax,)
  if return_handles:
    out += (handles,)
  if return_indices:
    out += (order,)
  return out[0] if len(out) == 1 else out


@host_arrays
def plot_relative_series(X: np.ndarray, row_name=None, col_name=None,
                         ax=None, linestyle: str = "--",
                         markerstyle: str = "o", grid: bool = True,
                         fontsize: int = 12, title: Optional[str] = None):
  """Rows of X plotted relative to the FIRST row as baseline (reference
  ``stats_plot.py:263``): each series shows its difference from row 0."""
  ax = to_axis(ax, figsize=(8, 4))
  X = np.asarray(X, np.float64)
  base = X[0]
  t = np.arange(X.shape[1])
  row_name = check_arg_length(row_name, X.shape[0],
                              converter=str) or []
  ax.axhline(0.0, color="k", lw=1)
  for i in range(1, X.shape[0]):
    label = row_name[i] if row_name[i] is not None else f"row{i}"
    ax.plot(t, X[i] - base, linestyle=linestyle, marker=markerstyle,
            label=label)
  if col_name is not None:
    ax.set_xticks(t)
    ax.set_xticklabels([str(c) for c in col_name], rotation=45, ha="right",
                       fontsize=fontsize - 2)
  base_label = row_name[0] if row_name and row_name[0] is not None \
      else "baseline"
  ax.set_ylabel(f"delta vs {base_label}", fontsize=fontsize)
  if grid:
    ax.grid(alpha=0.3)
  ax.legend(fontsize=fontsize - 2)
  if title:
    ax.set_title(title, fontsize=fontsize)
  _register(ax.figure)
  return ax


@host_arrays
def plot_comparison_track(Xs: Sequence[Sequence[float]],
                          legends: Sequence[str],
                          tick_labels: Sequence[str], ax=None,
                          draw_label: bool = True, fontsize: int = 10,
                          title: Optional[str] = None):
  """Multiple systems compared point-by-point across named tracks, each
  point annotated with its value (reference ``figures.py:353`` — the NIST
  SRE track-comparison figure)."""
  ax = to_axis(ax, figsize=(max(6, len(tick_labels)), 4))
  if len(Xs) != len(legends):
    raise ValueError(f"{len(Xs)} series but {len(legends)} legends")
  t = np.arange(len(tick_labels))
  for series, name in zip(Xs, legends):
    series = np.asarray(series, np.float64)
    ax.plot(t[:len(series)], series, marker="o", label=str(name))
    if draw_label:
      for xi, yi in zip(t, series):
        ax.annotate(f"{yi:.2f}", (xi, yi), fontsize=fontsize - 2,
                    textcoords="offset points", xytext=(0, 5), ha="center")
  ax.set_xticks(t)
  ax.set_xticklabels([str(l) for l in tick_labels], rotation=30,
                     ha="right", fontsize=fontsize)
  ax.legend(fontsize=fontsize - 1)
  if title:
    ax.set_title(title, fontsize=fontsize + 2)
  _register(ax.figure)
  return ax


# ---------------------------------------------------------------------------
# heatmap family — reference ``heatmap_plot.py:192,240,308,359,407``
# ---------------------------------------------------------------------------
@host_arrays
def plot_Cnorm(cnorm: np.ndarray, labels: Sequence, Ptrue=(0.1, 0.5),
               ax=None, title: Optional[str] = None, fontsize: int = 12):
  """Normalized detection-cost matrix: rows = operating priors `Ptrue`,
  columns = classes (reference ``heatmap_plot.py:192``; pairs with
  `backend.metrics.compute_Cnorm`)."""
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


@host_arrays
def plot_weights(x: np.ndarray, ax=None, colormap: str = "Greys",
                 cbar: bool = False, keep_aspect: bool = True):
  """2-D weight-matrix panel with symmetric scale and stats in the title
  (reference ``heatmap_plot.py:240``)."""
  ax = to_axis(ax)
  x = np.asarray(x, np.float64)
  if x.ndim != 2:
    raise ValueError(f"plot_weights needs a 2-D array, got {x.shape}")
  vmax = np.abs(x).max() or 1.0
  im = ax.imshow(x, cmap=colormap, vmin=-vmax, vmax=vmax,
                 aspect="equal" if keep_aspect else "auto",
                 interpolation="nearest")
  ax.set_xticks([])
  ax.set_yticks([])
  ax.set_title(f"{x.shape} mu={x.mean():.3f} sd={x.std():.3f}", fontsize=7)
  if cbar:
    ax.figure.colorbar(im, ax=ax)
  _register(ax.figure)
  return ax


@host_arrays
def plot_weights3D(x: np.ndarray, colormap: str = "Greys"):
  """Grid of 2-D slices of a 3-D weight tensor (reference
  ``heatmap_plot.py:308``)."""
  plt = _plt()
  x = np.asarray(x, np.float64)
  if x.ndim != 3:
    raise ValueError(f"plot_weights3D needs a 3-D array, got {x.shape}")
  n = x.shape[-1]
  c = int(math.ceil(math.sqrt(n)))
  r = int(math.ceil(n / c))
  fig, axes = plt.subplots(r, c, figsize=(c * 1.6, r * 1.6))
  vmax = np.abs(x).max() or 1.0
  for i, ax in enumerate(np.atleast_1d(axes).ravel()):
    if i < n:
      ax.imshow(x[..., i], cmap=colormap, vmin=-vmax, vmax=vmax,
                interpolation="nearest")
    ax.axis("off")
  fig.suptitle(f"{x.shape} mu={x.mean():.3f} sd={x.std():.3f}", fontsize=8)
  _register(fig)
  return fig


@host_arrays
def plot_weights4D(x: np.ndarray, colormap: str = "Greys"):
  """(H, W, Cin, Cout) conv kernels as a Cin x Cout grid of spatial
  filters (reference ``heatmap_plot.py:359``)."""
  plt = _plt()
  x = np.asarray(x, np.float64)
  if x.ndim != 4:
    raise ValueError(f"plot_weights4D needs a 4-D array, got {x.shape}")
  h, w, cin, cout = x.shape
  fig, axes = plt.subplots(cin, cout,
                           figsize=(cout * 0.8 + 1, cin * 0.8 + 1),
                           squeeze=False)
  vmax = np.abs(x).max() or 1.0
  for i in range(cin):
    for j in range(cout):
      axes[i][j].imshow(x[:, :, i, j], cmap=colormap, vmin=-vmax,
                        vmax=vmax, interpolation="nearest")
      axes[i][j].axis("off")
  fig.suptitle(f"{x.shape} mu={x.mean():.3f} sd={x.std():.3f}", fontsize=8)
  _register(fig)
  return fig


@host_arrays
def plot_distance_heatmap(X: np.ndarray, labels=None, ax=None,
                          metric: str = "euclidean", cmap: str = "magma",
                          sort_by_label: bool = True,
                          title: Optional[str] = None,
                          fontsize: int = 10):
  """Pairwise-distance matrix, rows grouped by label with class boundary
  lines (reference ``heatmap_plot.py:407`` — embedding cluster QA)."""
  ax = to_axis(ax)
  X = np.asarray(X, np.float64)
  n = X.shape[0]
  labels = np.zeros(n, np.int64) if labels is None else np.asarray(labels)
  if sort_by_label:
    order = np.argsort(labels, kind="stable")
    X, labels = X[order], labels[order]
  if metric == "cosine":
    Xn = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
    D = 1.0 - Xn @ Xn.T
  else:
    sq = (X ** 2).sum(axis=1)
    D = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2.0 * X @ X.T, 0.0))
  im = ax.imshow(D, cmap=cmap, interpolation="nearest")
  bounds = np.nonzero(labels[1:] != labels[:-1])[0] + 1
  for b in bounds:
    ax.axhline(b - 0.5, color="cyan", lw=0.8)
    ax.axvline(b - 0.5, color="cyan", lw=0.8)
  edges = np.concatenate([[0], bounds, [n]])
  centers = (edges[:-1] + edges[1:]) / 2.0
  names = [str(labels[int(e)]) for e in edges[:-1]]
  ax.set_yticks(centers)
  ax.set_yticklabels(names, fontsize=fontsize - 2)
  ax.set_xticks([])
  ax.figure.colorbar(im, ax=ax)
  if title:
    ax.set_title(title, fontsize=fontsize)
  _register(ax.figure)
  return ax


# ---------------------------------------------------------------------------
# layered / text scatter — reference ``scatter_plot.py:480,577``
# ---------------------------------------------------------------------------
@host_arrays
def plot_scatter_text(x, y=None, val=None, marker=None, ax=None,
                      color: str = "bwr", size: float = 9.0,
                      alpha: float = 0.8, weight: str = "normal",
                      ticks_off: bool = True, fontsize: int = 10,
                      title: Optional[str] = None):
  """Scatter that draws a TEXT glyph per point (reference
  ``scatter_plot.py:480``): `marker` is the per-point string (e.g. class
  names), `val` colors the glyphs through `color`'s colormap."""
  plt = _plt()
  ax = to_axis(ax)
  x = np.asarray(x, np.float64)
  if y is None and x.ndim == 2:
    x, y = x[:, 0], x[:, 1]
  y = np.asarray(y, np.float64)
  n = len(x)
  marker = check_arg_length(marker, n, default="o", converter=str)
  if val is not None:
    val = np.asarray(val, np.float64).ravel()
    lo, hi = val.min(), val.max()
    norm = (val - lo) / (hi - lo if hi > lo else 1.0)
    cmap = plt.get_cmap(color)
    colors = [cmap(v) for v in norm]
  else:
    uniq = {m: i for i, m in enumerate(dict.fromkeys(marker))}
    cmap = plt.get_cmap("tab10")
    colors = [cmap(uniq[m] % 10) for m in marker]
  for xi, yi, mi, ci in zip(x, y, marker, colors):
    ax.text(xi, yi, mi, color=ci, fontsize=size, alpha=alpha,
            weight=weight, ha="center", va="center")
  ax.set_xlim(x.min() - 0.05 * np.ptp(x), x.max() + 0.05 * np.ptp(x))
  ax.set_ylim(y.min() - 0.05 * np.ptp(y), y.max() + 0.05 * np.ptp(y))
  if ticks_off:
    ax.set_xticks([])
    ax.set_yticks([])
  if title:
    ax.set_title(title, fontsize=fontsize)
  _register(ax.figure)
  return ax


@host_arrays
def plot_scatter_layers(x_y_val: Sequence, ax=None, layer_name=None,
                        layer_color=None, layer_marker=None,
                        size: float = 4.0, z_ratio: float = 4.0,
                        elev=None, azim=88, grid: bool = True,
                        ticks_off: bool = True, fontsize: int = 8,
                        title: Optional[str] = None):
  """Stack multiple (x, y, value) scatter layers along z in one 3-D axis
  (reference ``scatter_plot.py:577``): layer k is drawn at height k, value
  colors within each layer's own colormap."""
  plt = _plt()
  if len(x_y_val) < 2:
    raise ValueError("plot_scatter_layers needs >= 2 layers")
  ax = to_axis(ax, is_3D=True)
  k = len(x_y_val)
  layer_name = check_arg_length(layer_name, k, default="", converter=str)
  layer_color = check_arg_length(layer_color, k, default="Blues",
                                 converter=str)
  layer_marker = check_arg_length(layer_marker, k, default="o",
                                  converter=str)
  span = max(float(np.ptp(np.concatenate(
      [np.asarray(xy[0], np.float64).ravel() for xy in x_y_val]))), 1e-6)
  dz = span / float(z_ratio)
  for i, (x, y, val) in enumerate(x_y_val):
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    val = np.asarray(val, np.float64).ravel()
    sc = ax.scatter(x, y, np.full_like(x, i * dz), c=val,
                    cmap=plt.get_cmap(layer_color[i]),
                    marker=layer_marker[i], s=size,
                    label=layer_name[i] or None, depthshade=False)
    del sc
  if elev is not None or azim is not None:
    ax.view_init(elev=elev, azim=azim)
  if ticks_off:
    ax.set_zticks([])
  ax.grid(grid)
  if any(layer_name):
    ax.legend(loc="upper center", ncol=min(3, k), fontsize=fontsize)
  if title:
    ax.set_title(title, fontsize=fontsize + 2)
  _register(ax.figure)
  return ax


@host_arrays
def plot_histogram_layers(Xs, bins: int = 50, ax=None,
                          normalize: bool = False, range_0_1: bool = False,
                          layer_name=None, layer_color=None,
                          grid: bool = True, fontsize: int = 12,
                          title: Optional[str] = None):
  """Multiple histograms stacked along the depth axis of one 3-D plot
  (reference ``histogram_plot.py:171``).  `Xs` is a list of 1-D arrays or
  a 2-D array (one layer per column)."""
  ax = to_axis(ax, is_3D=True)
  if isinstance(Xs, np.ndarray) and Xs.ndim == 2:
    Xs = [Xs[:, i] for i in range(Xs.shape[1])]
  k = len(Xs)
  layer_name = check_arg_length(layer_name, k, default="", converter=str)
  layer_color = check_arg_length(layer_color, k, default=None)
  cmap = _plt().get_cmap("tab10")
  alphas = np.linspace(0.9, 0.6, k)
  for i, x in enumerate(Xs):
    x = np.asarray(x, np.float64).ravel()
    if range_0_1:
      lo, hi = x.min(), x.max()
      x = (x - lo) / (hi - lo if hi > lo else 1.0)
    hist, edges = np.histogram(x, bins=bins, density=normalize)
    centers = (edges[:-1] + edges[1:]) / 2.0
    width = (edges[1] - edges[0]) / 1.36
    color = layer_color[i] if layer_color[i] is not None else cmap(i % 10)
    ax.bar(centers - width / 2, hist, zs=float(i), zdir="y", width=width,
           color=color, ec=color, alpha=float(alphas[i]))
  ax.set_yticks(range(k))
  ax.set_yticklabels([layer_name[i] or str(i) for i in range(k)],
                     fontsize=fontsize - 2)
  ax.grid(grid)
  if title:
    ax.set_title(title, fontsize=fontsize)
  _register(ax.figure)
  return ax


# ---------------------------------------------------------------------------
# figure management — reference ``figures.py:48,234,284,305,1267``
# ---------------------------------------------------------------------------
@host_arrays
def plot_gridSpec(nrow: int, ncol: int, wspace=None, hspace=None):
  """New figure + GridSpec pair (reference ``figures.py:305``)."""
  plt = _plt()
  from matplotlib import gridspec
  fig = plt.figure()
  gs = gridspec.GridSpec(nrow, ncol, wspace=wspace, hspace=hspace)
  _register(fig)
  return fig, gs


@host_arrays
def plot_gridSubplot(shape, loc, colspan: int = 1, rowspan: int = 1):
  """`plt.subplot2grid` passthrough on the current figure (reference
  ``figures.py`` `plot_gridSubplot`)."""
  return _plt().subplot2grid(shape, loc, colspan=colspan, rowspan=rowspan)


@host_arrays
def merge_figures(figs: Sequence, ncol: Optional[int] = None,
                  dpi: int = 100):
  """Rasterize several figures and compose them into one grid figure
  (reference ``figures.py:234`` — declared but left `pass`; implemented
  here for real via `fig2data`)."""
  from odin_tpu_torch.visual import fig2data
  plt = _plt()
  figs = list(figs)
  n = len(figs)
  ncol = ncol or int(math.ceil(math.sqrt(n)))
  nrow = int(math.ceil(n / ncol))
  out = plt.figure(figsize=(ncol * 4, nrow * 3), dpi=dpi)
  for i, f in enumerate(figs):
    ax = out.add_subplot(nrow, ncol, i + 1)
    ax.imshow(fig2data(f, dpi=dpi))
    ax.axis("off")
  _register(out)
  return out


@host_arrays
def plot_title(title: str, ax=None, fontsize: int = 12):
  ax = to_axis(ax)
  ax.set_title(str(title), fontsize=fontsize)
  return ax


@host_arrays
def plot_aspect(aspect=None, adjustable=None, ax=None):
  """Set the axis aspect mode (reference ``figures.py:284``)."""
  ax = to_axis(ax)
  if aspect is not None and adjustable is None:
    ax.axis(aspect)
  elif aspect is not None:
    ax.set_aspect(aspect, adjustable)
  return ax


@host_arrays
def plot_show(block: bool = True):
  """`plt.show` passthrough; a no-op under the Agg backend (reference
  ``figures.py`` `plot_show`)."""
  try:
    _plt().show(block=block)
  except Exception:
    pass


@host_arrays
def plot_save_show(path: str, **kwargs):
  """Save pending figures, then show (reference `plot_save_show`)."""
  from odin_tpu_torch.visual import plot_save
  out = plot_save(path, **kwargs)
  plot_show(block=False)
  return out


@host_arrays
def plot_to_image(figure, close_figure: bool = True,
                  dpi: int = 150) -> np.ndarray:
  """Figure -> (1, H, W, 4) uint8 batch for TB image summaries (reference
  ``figures.py:1267``, sans the TF dependency)."""
  from odin_tpu_torch.visual import fig2data
  data = fig2data(figure, dpi=dpi)
  if close_figure:
    _plt().close(figure)
  return data[None]


@host_arrays
def time_ticks(locs, n_ticks: int = 5, axis: str = "x", time_fmt: str = "s",
               ax=None):
  """Human-readable time ticks on an axis (reference ``figures.py:48``):
  pick `n_ticks` evenly spaced locations from `locs` (timestamps in
  seconds) and format as ms/s/m/h."""
  ax = to_axis(ax)
  locs = np.asarray(locs, np.float64)
  idx = np.linspace(0, len(locs) - 1, num=min(n_ticks, len(locs)),
                    dtype=np.int64)

  def _fmt(v):
    if time_fmt == "ms":
      return f"{v * 1e3:.0f}ms"
    if time_fmt == "m":
      return f"{v / 60:.1f}m"
    if time_fmt == "h":
      return f"{v / 3600:.2f}h"
    return f"{v:.2f}s"

  labels = [_fmt(v) for v in locs[idx]]
  if axis == "y":
    ax.set_yticks(idx)
    ax.set_yticklabels(labels)
  else:
    ax.set_xticks(idx)
    ax.set_xticklabels(labels)
  return ax


# ---------------------------------------------------------------------------
# terminal plots — reference ``bashplot.py:574,756``
# ---------------------------------------------------------------------------
_ANSI = {"red": 31, "green": 32, "yellow": 33, "blue": 34, "magenta": 35,
         "cyan": 36, "white": 37, "gray": 90}


@host_arrays
def ctext(s: Any, color: str = "red") -> str:
  """ANSI-colored terminal text (reference ``plot_utils.py`` `ctext`)."""
  code = _ANSI.get(str(color).lower())
  return f"\x1b[{code}m{s}\x1b[0m" if code else str(s)


@host_arrays
def print_bar(f, height: int = 20, bincount: Optional[int] = None,
              pch: str = "o", title: Optional[str] = None) -> str:
  """Vertical ASCII histogram of a 1-D sample (reference
  ``bashplot.py:574``)."""
  x = np.asarray(f, np.float64).ravel()
  bins = bincount or min(40, max(10, int(math.sqrt(len(x)))))
  counts, edges = np.histogram(x, bins=bins)
  top = counts.max() or 1
  rows = []
  if title:
    rows.append(title)
  for level in range(height, 0, -1):
    cut = top * level / height
    rows.append("".join(pch if c >= cut else " " for c in counts))
  rows.append("-" * bins)
  rows.append(f"{edges[0]:<12.4g}{' ' * max(0, bins - 24)}{edges[-1]:>12.4g}")
  out = "\n".join(rows)
  print(out)
  return out


@host_arrays
def print_scatter(xs, ys, size: int = 20, pch: str = "o",
                  title: Optional[str] = None) -> str:
  """ASCII scatter plot on a size x 2*size character grid (reference
  ``bashplot.py:756``)."""
  xs = np.asarray(xs, np.float64).ravel()
  ys = np.asarray(ys, np.float64).ravel()
  w, h = 2 * size, size
  gx = np.clip(((xs - xs.min()) / (np.ptp(xs) or 1.0) * (w - 1)), 0,
               w - 1).astype(np.int64)
  gy = np.clip(((ys - ys.min()) / (np.ptp(ys) or 1.0) * (h - 1)), 0,
               h - 1).astype(np.int64)
  grid = [[" "] * w for _ in range(h)]
  for cx, cy in zip(gx, gy):
    grid[h - 1 - cy][cx] = pch
  rows = ([title] if title else []) + ["|" + "".join(r) + "|" for r in grid]
  rows.insert(1 if title else 0, "+" + "-" * w + "+")
  rows.append("+" + "-" * w + "+")
  out = "\n".join(rows)
  print(out)
  return out


@host_arrays
def print_hinton(matrix: np.ndarray, max_arr=None) -> str:
  """ASCII hinton diagram: glyph density encodes |weight| (reference
  ``bashplot.py`` `print_hinton`)."""
  chars = " .:-=+*#%@"
  m = np.asarray(matrix, np.float64)
  top = np.abs(m).max() or 1.0
  lines = []
  for row in m:
    lines.append("".join(
        chars[min(int(abs(v) / top * (len(chars) - 1)), len(chars) - 1)]
        for v in row))
  out = "\n".join(lines)
  print(out)
  return out


# ---------------------------------------------------------------------------
# Animation — reference ``animation.py:8``
# ---------------------------------------------------------------------------
class Animation:
  """Incrementally collect image-grid frames, then save one GIF (reference
  ``animation.py:8``).  Each `plot_images`/`plot_spectrogram` call appends
  one frame showing the whole minibatch as a tile."""

  def __init__(self, figsize=None):
    self.figsize = figsize
    self.frames: List[np.ndarray] = []

  def __len__(self):
    return len(self.frames)

  @host_arrays
  def plot_images(self, images) -> "Animation":
    images = np.asarray(images, np.float64)
    tile = tile_raster_images(images)
    if tile.ndim == 2:  # grayscale -> rgb
      lo, hi = tile.min(), tile.max()
      tile = (tile - lo) / (hi - lo if hi > lo else 1.0)
      tile = np.stack([tile] * 3, axis=-1)
    self.frames.append((np.clip(tile, 0, 1) * 255).astype(np.uint8)
                       if tile.max() <= 1.0 else tile.astype(np.uint8))
    return self

  @host_arrays
  def plot_spectrogram(self, spec, cmap: str = "magma") -> "Animation":
    spec = np.asarray(spec, np.float64)
    if spec.ndim == 2:
      spec = spec[None]
    # (N, T, D) -> per-item time-frequency images, colormapped
    plt = _plt()
    cm = plt.get_cmap(cmap)
    imgs = []
    for s in spec:
      lo, hi = s.min(), s.max()
      sn = (s - lo) / (hi - lo if hi > lo else 1.0)
      imgs.append(cm(sn.T)[..., :3])  # (D, T, 3)
    tile = tile_raster_images(np.stack(imgs))
    self.frames.append((np.clip(tile, 0, 1) * 255).astype(np.uint8))
    return self

  def save(self, path: str = "animation.gif", fps: int = 8,
           dpi: int = 80) -> str:
    from odin_tpu_torch.visual import plot_animation
    if not self.frames:
      raise RuntimeError("no frames collected")
    h = max(f.shape[0] for f in self.frames)
    w = max(f.shape[1] for f in self.frames)
    frames = np.stack([resize_images(f, (h, w)) for f in self.frames])
    return plot_animation(frames, path, fps=fps)


@host_arrays
def get_all_named_colors(to_hsv: bool = False):
  """All matplotlib named colors (reference ``plot_utils.py:20``)."""
  from matplotlib import colors as mcolors
  named = dict(mcolors.BASE_COLORS)
  named.update(mcolors.CSS4_COLORS)
  if to_hsv:
    named = {k: mcolors.rgb_to_hsv(mcolors.to_rgb(v))
             for k, v in named.items()}
  return named


@host_arrays
def plot_detection_curve(x, y, curve: str = "det", ax=None, label=None,
                         **kwargs):
  """Reference ``figures.py:1008`` dispatcher: ``curve`` selects DET
  (normal-deviate Pfa/Pmiss), ROC (fpr/tpr), or PRC (recall/precision)
  axes over the same two input arrays."""
  from odin_tpu_torch.visual import plot_det_curve
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
