"""The port's plots (``odin_tpu_torch.visual`` and ``.extended``) against
the JAX package's, each public name on the same inputs: numpy arrays for
JAX, the same values as tensors for the port (which copies them to the
host).

A figure is compared by its data on the Agg backend: each axis's lines'
xy, images' arrays, collections' offsets, patches' outlines and its texts
(title, labels, tick labels, annotations); a text plot by the string it
returns and prints; an array, a palette or a colormap by its values.
"""
import io
import os
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.axes import Axes  # noqa: E402
from matplotlib.colors import Colormap  # noqa: E402
from matplotlib.figure import Figure  # noqa: E402

import odin_tpu.visual as jax_visual  # noqa: E402
import odin_tpu.visual.extended as jax_extended  # noqa: E402
import odin_tpu_torch.visual as port_visual  # noqa: E402
import odin_tpu_torch.visual.extended as port_extended  # noqa: E402

JAX = types.SimpleNamespace(v=jax_visual, e=jax_extended, t=lambda a: a)
PORT = types.SimpleNamespace(v=port_visual, e=port_extended,
                             t=lambda a: torch.from_numpy(np.array(a, order="C")))
RS = np.random.RandomState(0)
IMAGES = RS.rand(6, 8, 8).astype(np.float32)
MAT = RS.randn(5, 4).astype(np.float32)
X2 = RS.randn(60, 2).astype(np.float32)
LABELS = RS.randint(0, 3, 60)
SPEC = RS.rand(50, 20).astype(np.float32)


def _texts(ax):
  return ([ax.get_title(), ax.get_xlabel(), ax.get_ylabel()] +
          [t.get_text() for t in ax.get_xticklabels()] +
          [t.get_text() for t in ax.get_yticklabels()] +
          [(tuple(np.round(t.get_position(), 6)), t.get_text())
           for t in ax.texts])


def _axis_data(ax):
  out = {"texts": _texts(ax),
         "lines": [np.asarray(l.get_xydata()) for l in ax.lines],
         "images": [np.asarray(im.get_array()) for im in ax.images],
         "collections": [np.asarray(getattr(c, "_offsets3d", None) or
                                    c.get_offsets(), dtype=np.float64)
                         for c in ax.collections],
         "patches": [p.get_patch_transform().transform(
             p.get_path().vertices) for p in ax.patches]}
  out["spines"] = {k: v.get_visible() for k, v in ax.spines.items()}
  legend = ax.get_legend()
  if legend is not None:
    out["legend"] = [t.get_text() for t in legend.get_texts()]
  return out


def _data(x):
  """What a plot returned, as comparable values."""
  if type(x).__name__ == "Colorbar":
    x = x.ax
  if isinstance(x, Axes):
    x = x.figure
  if isinstance(x, Figure):
    return [_axis_data(ax) for ax in x.axes] + [x._suptitle.get_text()
                                                if x._suptitle else None]
  if isinstance(x, Colormap):
    return x.name, np.asarray(x(np.linspace(0, 1, 7)))
  if isinstance(x, (list, tuple)):
    return [_data(v) for v in x]
  if isinstance(x, dict):
    return {k: _data(v) for k, v in x.items()}
  if hasattr(x, "get_gridspec") or type(x).__name__ == "GridSpec":
    return repr(x.get_geometry()) if hasattr(x, "get_geometry") else repr(x)
  return x


def _equal(a, b):
  if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "fc" or b.dtype.kind in "fc":
      return a.shape == b.shape and np.allclose(a, b, rtol=0, atol=0,
                                                equal_nan=True)
    return a.shape == b.shape and np.array_equal(a, b)
  if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
    return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
  if isinstance(a, dict) and isinstance(b, dict):
    return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
  return a == b


# -- visual/__init__.py --------------------------------------------------------
def _images(M):
  return M.v.plot_images(M.t(IMAGES), title="grid")


def _spectrogram(M):
  return M.v.plot_spectrogram(M.t(SPEC), sr=8000, hop=80, title="spec")


def _heatmap(M):
  return M.v.plot_heatmap(M.t(MAT), row_labels=list("abcde"),
                          col_labels=list("wxyz"), annotate=True, title="h")


def _det(M):
  pfa = np.linspace(0.01, 0.5, 20)
  return M.v.plot_det_curve(M.t(pfa), M.t(pfa[::-1]), label="det")


def _scatter(M):
  return (M.v.plot_scatter(M.t(X2), color=M.t(LABELS), title="s"),
          M.v.plot_scatter(M.t(X2[:, 0]), M.t(X2[:, 1])))


def _histogram(M):
  return M.v.plot_histogram(M.t(X2[:, 0]), bins=12, title="hist")


def _series(M):
  y = np.random.RandomState(1).randn(3, 30).cumsum(-1)
  return (M.v.plot_series(M.t(y), smooth=0.5, title="series"),
          M.v.plot_series({"a": M.t(y[0]), "b": M.t(y[1])}))


def _comparison_series(M):
  return M.v.plot_comparison_series(
      {"base": M.t(np.arange(10.0)), "new": M.t(np.arange(10.0) ** 1.1)},
      baseline="base", title="cmp")


def _confusion_matrix(M):
  cm = np.array([[5, 1, 0], [2, 7, 1], [0, 0, 9]])
  return (M.v.plot_confusion_matrix(M.t(cm), labels=["a", "b", "c"],
                                    title="cm"),
          M.v.plot_confusion_matrix(M.t(cm), normalize=False))


def _gaussian_mixture(M):
  x = np.concatenate([np.random.RandomState(2).randn(100) - 2,
                      np.random.RandomState(3).randn(100) + 2])
  return M.v.plot_gaussian_mixture(M.t(x), M.t(np.array([-2.0, 2.0])),
                                   M.t(np.array([1.0, 1.0])),
                                   weights=M.t(np.array([0.5, 0.5])),
                                   bins=20, title="gmm")


def _ellipses(M):
  return M.v.plot_ellipses(M.t(np.array([0.5, -1.0])),
                           M.t(np.array([[2.0, 0.3], [0.3, 1.0]])),
                           n_std=1.5)


def _hinton(M):
  return M.v.plot_hinton(M.t(MAT), title="hinton")


def _multiple_features(M):
  return M.v.plot_multiple_features({"mspec": M.t(SPEC),
                                     "energy": M.t(SPEC[:, 0])},
                                    title="features")


def _fig_roundtrip(M):
  ax = M.v.plot_heatmap(M.t(MAT))
  data = M.v.fig2data(ax.figure, dpi=50)
  return data, M.v.data2fig(M.t(data[..., :3]))


def _figure_and_marks(M):
  fig = M.v.plot_figure(nrows=3, ncols=4, dpi=50)
  ax = fig.add_subplot(111)
  ax.plot(np.arange(10), np.arange(10))
  M.v.plot_vline(M.t(np.array([2.0, 5.0])), ax=ax)
  M.v.plot_indices(M.t(np.array([1, 3, 7])), ax=ax)
  M.v.plot_frame(ax, left=False, top=False)
  cb = M.v.plot_colorbar("magma", vmin=-1.0, vmax=2.0, label="cb")
  return fig, cb, [fig.get_size_inches()]


def _text_plots(M):
  out = io.StringIO()
  with redirect_stdout(out):
    got = (M.v.print_dist({"a": M.t(np.array(3.0)), "bb": 7, "c": 0}),
           M.v.print_hist(M.t(X2[:, 0]), bins=8, width=20),
           M.v.print_confusion(M.t(np.array([[5, 1], [2, 7]])),
                               labels=["yes", "no"]),
           M.e.print_bar(M.t(X2[:, 1]), height=6, title="bar"),
           M.e.print_scatter(M.t(X2[:, 0]), M.t(X2[:, 1]), size=8,
                             title="sc"),
           M.e.print_hinton(M.t(MAT)), M.e.ctext("x", "green"),
           M.e.ctext("y", "none"))
  return got, out.getvalue()


def _save(M, tmp="figs"):
  os.makedirs(tmp, exist_ok=True)
  M.v.plot_close()
  M.v.plot_heatmap(M.t(MAT))
  M.v.plot_hinton(M.t(MAT))
  path = M.v.plot_save(os.path.join(tmp, "all.pdf"))
  viz = M.v.Visualizer()
  viz.add_figure("h", M.v.plot_heatmap(M.t(MAT)).figure)
  out = viz.save_figures(os.path.join(tmp, "viz.pdf"))
  sizes = [os.path.getsize(p) > 1000 for p in (path, out)]
  with open(path, "rb") as f:
    pages = f.read().count(b"/Type /Page\n") or f.read().count(b"/Page")
  return os.path.basename(path), os.path.basename(out), sizes, pages, \
      len(M.v._FIGURES), viz._figures


def _animation_gif(M):
  os.makedirs("anim", exist_ok=True)
  frames = (np.random.RandomState(4).rand(3, 6, 6) * 255).astype(np.uint8)
  path = M.v.plot_animation(M.t(frames), os.path.join("anim", "a.gif"))
  anim = M.e.Animation()
  anim.plot_images(M.t(IMAGES[:4])).plot_spectrogram(M.t(SPEC[None]))
  out = anim.save(os.path.join("anim", "b.gif"))
  from PIL import Image
  return ([np.asarray(Image.open(p).convert("RGB")) for p in (path, out)],
          len(anim), [f.copy() for f in anim.frames])


# -- visual/extended.py --------------------------------------------------------
def _series_statistics(M):
  obs = np.abs(np.random.RandomState(5).randn(12)) + 1
  return M.e.plot_series_statistics(
      observed=M.t(obs), expected=M.t(obs * 0.9),
      total_stdev=M.t(obs * 0.1), explained_stdev=M.t(obs * 0.05),
      title="stats")


def _relative_series(M):
  return M.e.plot_relative_series(M.t(MAT), row_name=list("abcde"),
                                  col_name=list("wxyz"), title="rel")


def _comparison_track(M):
  return M.e.plot_comparison_track(
      [M.t(np.arange(5.0)), M.t(np.arange(5.0)[::-1])], ["up", "down"],
      list("abcde"), title="track")


def _cnorm(M):
  return M.e.plot_Cnorm(M.t(np.array([[0.1, 0.2], [0.3, 0.4]])), ["a", "b"],
                        title="C")


def _weights(M):
  return (M.e.plot_weights(M.t(MAT), cbar=True),
          M.e.plot_weights3D(M.t(np.random.RandomState(6).randn(3, 4, 5))),
          M.e.plot_weights4D(M.t(np.random.RandomState(7).randn(2, 3, 4,
                                                                  4))))


def _distance_heatmap(M):
  return M.e.plot_distance_heatmap(M.t(X2[:12]), labels=M.t(LABELS[:12]),
                                   title="dist")


def _scatter_text(M):
  return M.e.plot_scatter_text(M.t(X2[:10]), val=M.t(np.arange(10)),
                               title="st")


def _scatter_layers(M):
  layers = [(M.t(X2[:20, 0]), M.t(X2[:20, 1]), M.t(LABELS[:20])),
            (M.t(X2[20:40, 0]), M.t(X2[20:40, 1]), M.t(LABELS[20:40]))]
  return M.e.plot_scatter_layers(layers, layer_name=["l0", "l1"],
                                 title="layers")


def _histogram_layers(M):
  return M.e.plot_histogram_layers([M.t(X2[:, 0]), M.t(X2[:, 1])], bins=10,
                                   layer_name=["a", "b"], title="hl")


def _grids_and_titles(M):
  fig, gs = M.e.plot_gridSpec(2, 3, wspace=0.1)
  ax = M.e.plot_gridSubplot((2, 3), (0, 1), colspan=2)
  M.e.plot_title("T", ax=ax)
  M.e.plot_aspect("equal", ax=ax)
  ax.plot([0, 1], [1, 0])
  M.e.time_ticks(M.t(np.arange(0, 100, 10)), n_ticks=4, ax=ax)
  return gs.get_geometry(), ax, ax.get_aspect(), fig is ax.figure


def _merge_and_image(M):
  a, b = M.v.plot_heatmap(M.t(MAT)), M.v.plot_hinton(M.t(MAT))
  merged = M.e.merge_figures([a.figure, b.figure], ncol=2, dpi=40)
  image = M.e.plot_to_image(M.v.plot_heatmap(M.t(MAT)).figure, dpi=40)
  return merged, image


def _show_and_save(M):
  M.v.plot_close()
  M.v.plot_heatmap(M.t(MAT))
  M.e.plot_show(block=False)
  path = M.e.plot_save_show("shown.pdf")
  return os.path.basename(path), os.path.getsize(path) > 1000


def _rasters(M):
  rgb = np.random.RandomState(8).rand(5, 6, 7, 3).astype(np.float32)
  return (M.e.tile_raster_images(M.t(IMAGES), images_per_row=3),
          M.e.tile_raster_images(M.t(rgb)),
          M.e.resize_images(M.t(IMAGES), (12, 5)),
          M.e.resize_images(M.t(rgb[0]), (3, 3)))


def _palettes(M):
  return (M.e.generate_random_colors(5), M.e.generate_random_colors(
      3, seed=2, lightness_value=0.4, return_hex=False),
          M.e.generate_random_colors(2, return_hsl=True),
          M.e.generate_random_colormaps(2),
          M.e.generate_random_colormaps(2, bicolors=True),
          M.e.generate_palette_colors(4), M.e.generate_random_marker(4),
          M.e.generate_random_marker(20, seed=3),
          len(M.e.get_all_named_colors()),
          M.e.get_all_named_colors(to_hsv=True)["red"])


def _arg_length(M):
  return (M.e.check_arg_length(None, 3, default=1),
          M.e.check_arg_length(M.t(np.array([2.0])), 3),
          M.e.check_arg_length([1, None], 2, default=0, converter=float),
          M.e.check_arg_length("a", 2))


def _detection_curves(M):
  x = np.linspace(0.01, 0.99, 15)
  return [M.e.plot_detection_curve(M.t(x), M.t(np.sqrt(x)), curve=c,
                                   ax=M.v.to_axis(), label=c)
          for c in ("det", "roc", "prc")]


def _to_axis(M):
  return M.e.to_axis(figsize=(2, 3)), M.e.to_axis(is_3D=True).name


CASES = {
    "plot_images": _images, "plot_spectrogram": _spectrogram,
    "plot_heatmap": _heatmap, "plot_det_curve": _det,
    "plot_scatter": _scatter, "plot_histogram": _histogram,
    "plot_series": _series, "plot_comparison_series": _comparison_series,
    "plot_confusion_matrix": _confusion_matrix,
    "plot_gaussian_mixture": _gaussian_mixture,
    "plot_ellipses": _ellipses, "plot_hinton": _hinton,
    "plot_multiple_features": _multiple_features,
    "fig2data_data2fig": _fig_roundtrip,
    "plot_figure_vline_indices_frame_colorbar": _figure_and_marks,
    "print_plots": _text_plots, "plot_save_Visualizer": _save,
    "plot_animation_Animation": _animation_gif,
    "plot_series_statistics": _series_statistics,
    "plot_relative_series": _relative_series,
    "plot_comparison_track": _comparison_track, "plot_Cnorm": _cnorm,
    "plot_weights": _weights, "plot_distance_heatmap": _distance_heatmap,
    "plot_scatter_text": _scatter_text,
    "plot_scatter_layers": _scatter_layers,
    "plot_histogram_layers": _histogram_layers,
    "grids_titles_ticks": _grids_and_titles,
    "merge_figures_plot_to_image": _merge_and_image,
    "plot_show_save_show": _show_and_save, "rasters": _rasters,
    "palettes": _palettes, "check_arg_length": _arg_length,
    "plot_detection_curve": _detection_curves, "to_axis": _to_axis,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_plot_matches_jax(name, tmp_path, monkeypatch):
  got = []
  for side, M in (("jax", JAX), ("port", PORT)):
    os.makedirs(tmp_path / side)
    monkeypatch.chdir(tmp_path / side)
    plt.close("all")
    got.append(_data(CASES[name](M)))
  plt.close("all")
  port_visual._FIGURES.clear()
  jax_visual._FIGURES.clear()
  assert _equal(*got), got


def test_every_name_of_jax_visual():
  """Every name of JAX's ``visual.__all__`` is in the port's, and every
  public definition of JAX's ``extended`` in the port's ``extended``."""
  assert set(jax_visual.__all__) <= set(port_visual.__all__)
  for name in jax_visual.__all__:
    assert hasattr(port_visual, name), name
  jax_names = {n for n, o in vars(jax_extended).items()
               if not n.startswith("_") and callable(o) and
               getattr(o, "__module__", "") == jax_extended.__name__}
  assert jax_names <= set(port_extended.__all__)


def test_plots_take_tensors_on_any_device_and_with_gradients():
  """A tensor that needs a gradient, and a bfloat16 one, plot as their
  values do (``to_host``)."""
  x = torch.from_numpy(MAT).requires_grad_()
  a = _data(port_visual.plot_heatmap(x))
  b = _data(port_visual.plot_heatmap(MAT))
  assert _equal(a, b)
  h = torch.from_numpy(MAT).to(torch.bfloat16)
  text = port_extended.print_hinton(h)
  assert text == jax_extended.print_hinton(h.float().numpy())
  plt.close("all")


def test_without_matplotlib_a_plot_names_it():
  """With matplotlib absent (as on the card's machine) the plots import,
  the text plots run, and a figure raises the ImportError naming
  matplotlib."""
  import subprocess
  import sys
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  code = "\n".join([
      "import sys",
      "sys.modules['matplotlib'] = None",
      "import torch",
      "from odin_tpu_torch import visual",
      "from odin_tpu_torch.visual import extended",
      "x = torch.arange(6.0).reshape(2, 3)",
      "print(extended.print_hinton(x) == extended.print_hinton(x.numpy()))",
      "for fn in (visual.plot_heatmap, extended.plot_weights):",
      "  try:",
      "    fn(x)",
      "  except ImportError as e:",
      "    print('matplotlib' in str(e))"])
  res = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=root))
  assert res.returncode == 0, res.stderr
  assert res.stdout.split()[-3:] == ["True", "True", "True"], res.stdout
