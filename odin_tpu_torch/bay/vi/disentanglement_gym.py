"""DisentanglementGym of the port (PyTorch port of
``odin_tpu/bay/vi/disentanglement_gym.py``): ``GroundTruth``,
``concat_mean``, ``first_mean`` and ``DisentanglementGym`` with
``run_model``, every score and ``write_report``.

The Gym runs where its model lives (the card, unless the model was built
with ``device='cpu'``): ``run_model`` encodes and decodes the evaluation
set in batches without gradients and keeps the posterior, the
reconstruction and the per-sample ELBO terms there, and every score runs
the port's estimators on the latents there.  Each plot computes what it
draws there too, in a private ``_plot_data_<name>`` helper (the decodes,
the prior samples, the per-pixel −log p(x|z), the histograms, the aligned
correlation matrix, the t-SNE embedding), and draws it on the host with
matplotlib, imported (with the Agg backend) only when a plot is drawn.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from odin_tpu_torch.backend.metrics import frechet_inception_distance as _fid
from odin_tpu_torch.bay.distributions.base import kl_registry_lookup
from odin_tpu_torch.bay.helpers import (concat_distributions, kl_divergence,
                                        map_distributions)
from odin_tpu_torch.bay.vi import downstream_metrics as _dm
from odin_tpu_torch.bay.vi import metrics as _metrics
from odin_tpu_torch.bay.vi.estimators import (LogisticRegression,
                                              train_test_split)
from odin_tpu_torch.bay.vi.losses import total_correlation as _tc
from odin_tpu_torch.bay.vi.utils import discretizing
from odin_tpu_torch.device import resolve_device
from odin_tpu_torch.ml.tsne import TSNE
from odin_tpu_torch.search import diagonal_linear_assignment
from odin_tpu_torch.training.core import Noise

__all__ = ["GroundTruth", "DisentanglementGym", "concat_mean", "first_mean",
           "plot_latent_stats"]

_CHUNK = 256  # rows a step where a score's work grows with rows squared


def _reshape2D(x) -> torch.Tensor:
  x = torch.as_tensor(x)
  return x.reshape(x.shape[0], -1)


def concat_mean(dists: Sequence[Any]) -> torch.Tensor:
  """The 2-D means of several distributions, side by side."""
  return torch.cat([_reshape2D(d.mean()) for d in dists], -1)


def first_mean(dists: Sequence[Any]) -> torch.Tensor:
  """The 2-D mean of the first distribution."""
  return _reshape2D(dists[0].mean())


def _pyplot():
  import matplotlib
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt
  return plt


def _host(x) -> np.ndarray:
  return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
      np.asarray(x)


def _finish(fig, path: Optional[str]):
  """Save `fig` to `path` and return the path, or return the figure."""
  if path:
    fig.savefig(path, dpi=120)
    _pyplot().close(fig)
    return path
  return fig


def _histograms(z: torch.Tensor, n_bins: int):
  """Each column's histogram as numpy's ``histogram(bins=n_bins)`` makes
  it (edges in the column's dtype from its extremes, the last bin closed),
  counted on the device: ([counts (n_bins,)], [edges (n_bins + 1,)])."""
  counts, edges = [], []
  for j in range(z.shape[1]):
    col = z[:, j]
    lo, hi = (float(v) for v in torch.aminmax(col))
    if lo == hi:
      lo, hi = lo - 0.5, hi + 0.5
    np_dtype = np.float32 if col.dtype == torch.float32 else np.float64
    e = np.linspace(np_dtype(lo), np_dtype(hi), n_bins + 1)
    inner = torch.as_tensor(e[1:-1]).to(col.device)
    bins = torch.searchsorted(inner, col.contiguous(), right=True)
    counts.append(torch.bincount(bins, minlength=n_bins).cpu().numpy())
    edges.append(e)
  return counts, edges


def _stairs(ax, counts, edges, **kwargs):
  """A density histogram drawn from counts and edges."""
  widths = np.diff(edges.astype(np.float64))
  ax.stairs(counts / widths / max(1, counts.sum()), edges, fill=True,
            **kwargs)


def plot_latent_stats(mean, stddev, kld=None, weights=None, ax=None,
                      name: str = "q(z|x)"):
  """Per-dimension latent statistics: the mean and stddev on the left
  axis, KL(q|p) and decoder weight norms on a twin axis.  Returns the
  figure."""
  plt = _pyplot()
  if ax is None:
    _, ax = plt.subplots(figsize=(8, 3))
  l1 = ax.plot(_host(mean), label="mean", linewidth=0.5, marker="o",
               markersize=3, color="r", alpha=0.5)
  l2 = ax.plot(_host(stddev), label="stddev", linewidth=0.5, marker="^",
               markersize=3, color="g", alpha=0.5)
  ax.tick_params(axis="y", colors="r")
  ax.set_ylabel(f"{name} Mean", color="r")
  ax.grid(True)
  lines = l1 + l2
  if kld is not None or weights is not None:
    ax2 = ax.twinx()
    if kld is not None:
      lines += ax2.plot(_host(kld), label="KL(q|p)", linestyle="--",
                        color="y", marker="s", markersize=2.5, linewidth=1.0,
                        alpha=0.5)
    if weights is not None:
      lines += ax2.plot(_host(weights), label="weights", linestyle="--",
                        color="b", marker="s", markersize=2.5, linewidth=1.0,
                        alpha=0.5)
    ax2.grid(False)
  ax.legend(lines, [ln.get_label() for ln in lines], fontsize=7)
  return ax.figure


class GroundTruth:
  """The ground-truth factor matrix (host numpy) and its sampling helpers.
  Columns that are not integers with at most 64 values are discretized
  into `n_bins` bins (``discretizing`` on `device`)."""

  def __init__(self, factors, factor_names: Optional[Sequence[str]] = None,
               categorical: Union[bool, Sequence[bool]] = False,
               n_bins: int = 8, strategy: str = "uniform", device=None):
    factors = np.asarray(factors.cpu() if isinstance(factors, torch.Tensor)
                         else factors)
    if factors.ndim == 1:
      factors = factors[:, None]
    self.factors_original = factors
    self.factor_names = list(factor_names) if factor_names is not None else \
        [f"factor{i}" for i in range(factors.shape[1])]
    is_discrete = np.array([
        np.allclose(factors[:, i], np.round(factors[:, i])) and
        len(np.unique(factors[:, i])) <= 64
        for i in range(factors.shape[1])])
    if np.all(is_discrete):
      self.factors = factors.astype(np.int64)
    else:
      cols = []
      for i in range(factors.shape[1]):
        if is_discrete[i]:
          cols.append(factors[:, i].astype(np.int64))
        else:
          cols.append(discretizing(factors[:, i:i + 1], n_bins=n_bins,
                                   strategy=strategy,
                                   device=device).cpu().numpy().ravel())
      self.factors = np.stack(cols, -1)

  @property
  def n_factors(self) -> int:
    return self.factors.shape[1]

  @property
  def shape(self):
    return self.factors.shape

  def sample_factors(self, n: int = 16, seed: int = 1
                     ) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(seed)
    idx = rng.choice(len(self.factors), size=n, replace=False)
    return self.factors[idx], idx

  def sample_indices_from_factors(self, factors: np.ndarray,
                                  seed: int = 1) -> np.ndarray:
    """Rows of the dataset matching each requested factor combination
    (the nearest in L1, one drawn at random among ties)."""
    rng = np.random.RandomState(seed)
    out = []
    for f in np.atleast_2d(factors):
      dist = np.sum(np.abs(self.factors - f), axis=1)
      out.append(rng.choice(np.where(dist == dist.min())[0]))
    return np.asarray(out)


class DisentanglementGym:
  """Evaluate a VAE's latent space against ground-truth factors::

    gym = DisentanglementGym(dataset=get_dataset("dsprites"), model=vae)
    gym.run_model(n_samples=10000, partition="test")
    scores = gym.write_report("report.txt")

  It runs on the model's device (`device` overrides it)."""

  def __init__(self, dataset=None, model=None, x: Optional[np.ndarray] = None,
               y: Optional[np.ndarray] = None, batch_size: int = 64,
               seed: int = 1, device=None):
    self.model = model
    self.dataset = dataset
    self.batch_size = int(batch_size)
    self.seed = int(seed)
    self._x, self._y = x, y
    if device is None:
      device = getattr(model, "device", None) or "cuda"
    self.device = resolve_device(device)
    self.x_true: Optional[np.ndarray] = None
    self.factors: Optional[np.ndarray] = None
    self.qz = None
    self.px = None
    self.groundtruth: Optional[GroundTruth] = None
    self._z_mean: Optional[torch.Tensor] = None
    self._z_discrete: Optional[torch.Tensor] = None
    self._factors_t: Optional[torch.Tensor] = None
    self._llk_total: Optional[torch.Tensor] = None
    self._kl_total: Optional[torch.Tensor] = None

  # -- data collection --------------------------------------------------------
  @torch.no_grad()
  def run_model(self, n_samples: int = 1000, partition: str = "test",
                n_bins: int = 8, verbose: bool = False, eps=None):
    """Collect x, the factors, q(z|x), p(x|z) and the per-sample ELBO
    terms over the evaluation set, in batches of `batch_size` on the
    model's device (the tail padded with the first rows, then trimmed).

    The ELBO's terms are the model's own ``elbo_components``, the noise of
    every batch the same (B, zdim) standard normals, as JAX draws every
    batch's from one key: drawn from a generator seeded `seed`, or `eps`
    (B, zdim) given, as a test gives the JAX package's draws."""
    if self._x is not None:
      x, y = self._x, self._y
    else:
      x, y = self.dataset.numpy(partition)
      if hasattr(self.dataset, "normalize255"):
        x = self.dataset.normalize255(x)
    if n_samples > 0:
      x, y = x[:n_samples], (y[:n_samples] if y is not None else None)
    self.x_true = np.asarray(x)
    self.factors = np.asarray(y) if y is not None else None
    n, bs = len(x), self.batch_size
    n_pad = (-n) % bs
    xp = np.concatenate([x, x[:n_pad]]) if n_pad else np.asarray(x)
    model, dev = self.model, self.device
    state = model.state

    def total(terms):
      out = torch.zeros(bs, dtype=torch.float32, device=dev)
      for v in terms.values():
        v = v.to(torch.float32)
        if v.ndim > 1:  # average sample dims, keep the trailing batch axis
          v = v.mean(dim=tuple(range(v.ndim - 1)))
        out = out + v
      return out

    elbo_ok = True
    qzs, pxs, llks, kls = [], [], [], []
    for i in range(0, len(xp), bs):
      batch = torch.as_tensor(xp[i:i + bs], dtype=torch.float32).to(dev)
      qz, px = model.reconstruct(batch)
      qzs.append(qz)
      pxs.append(px)
      if elbo_ok:
        noise = Noise(eps=eps) if eps is not None else Noise(
            torch.Generator(dev).manual_seed(self.seed))
        try:
          llk, kl, _ = model.elbo_components(state.params, batch, noise,
                                             state.step, False,
                                             state.mutables)
        except (TypeError, ValueError, KeyError, NotImplementedError):
          elbo_ok = False  # e.g. an objective that needs labels
        else:
          llks.append(total(llk))
          kls.append(total(kl))

    def trim(d):
      return map_distributions(lambda t: t[:n], d) if n_pad else d

    self._llk_total = torch.cat(llks)[:n] if elbo_ok and llks else None
    self._kl_total = torch.cat(kls)[:n] if elbo_ok and kls else None
    self.qz = trim(concat_distributions(qzs, axis=0))
    self.px = trim(concat_distributions(pxs, axis=0))
    self._z_mean = self.qz.mean()
    self._z_discrete = discretizing(self._z_mean, n_bins=n_bins,
                                    strategy="uniform")
    if self.factors is not None:
      self.groundtruth = GroundTruth(self.factors,
                                     getattr(self.dataset, "labels", None),
                                     device=dev)
      self._factors_t = torch.as_tensor(self.groundtruth.factors).to(dev)
    return self

  def _require_run(self):
    if self._z_mean is None:
      raise RuntimeError("call run_model() first")

  @property
  def z_mean(self) -> torch.Tensor:
    self._require_run()
    return self._z_mean

  # -- scores -------------------------------------------------------------------
  def mig_score(self, protocol: str = "reference") -> float:
    """Mutual information gap.  protocol='reference' uses ``run_model``'s
    `n_bins` equal-width bins; 'dlib' re-bins the posterior means into the
    20 that disentanglement_lib's published numbers use."""
    self._require_run()
    codes = (discretizing(self._z_mean, n_bins=20, strategy="uniform")
             if protocol == "dlib" else self._z_discrete)
    return _metrics.mutual_info_gap(codes, self._factors_t)

  def sap_score(self) -> float:
    """Separated attribute predictability."""
    self._require_run()
    return _dm.separated_attr_predictability(self._z_mean, self._factors_t,
                                             seed=self.seed)

  def dci_score(self) -> Tuple[float, float, float]:
    """(disentanglement, completeness, informativeness)."""
    self._require_run()
    return _dm.dci_scores(self._z_mean, self._factors_t, seed=self.seed)

  def betavae_score(self, n_samples: Optional[int] = None,
                    protocol: str = "reference") -> float:
    """Higgins' beta-VAE metric.  protocol='reference': 10 MCMC samples of
    z, pair batches of 10, `n_samples` votes (default 2,000).
    protocol='dlib' (disentanglement_lib's ``beta_vae_sklearn``): the
    posterior mean, pair batches of 64, `n_samples` train votes (default
    10,000) scored on 5,000 held-out votes."""
    self._require_run()
    if protocol == "dlib":
      return _dm.beta_vae_score(self.qz, self._factors_t, n_mcmc=0,
                                batch_size=64, n_samples=n_samples or 10_000,
                                n_eval_samples=5_000, seed=self.seed)
    return _dm.beta_vae_score(self.qz, self._factors_t,
                              n_samples=n_samples or 2_000, seed=self.seed)

  def factorvae_score(self, n_samples: Optional[int] = None,
                      protocol: str = "reference") -> float:
    """Kim & Mnih's FactorVAE metric.  protocol='reference': 10 MCMC
    samples of z, batches of 256, `n_samples` votes (default 2,000).
    protocol='dlib': the posterior mean, batches of 64, `n_samples` train
    votes (default 10,000) with 5,000 held-out votes, latents pruned at
    std < 0.05."""
    self._require_run()
    if protocol == "dlib":
      return _dm.factor_vae_score(self.qz, self._factors_t, n_mcmc=0,
                                  batch_size=64,
                                  n_samples=n_samples or 10_000,
                                  n_eval_samples=5_000, prune_threshold=0.05,
                                  prune_scale="std", seed=self.seed)
    return _dm.factor_vae_score(self.qz, self._factors_t,
                                n_samples=n_samples or 2_000, seed=self.seed)

  def clustering_score(self, factor_index: int = 0) -> Dict[str, float]:
    """ARI, AMI and NMI of a k-means clustering of the posterior means
    against one factor, and their silhouette under it."""
    self._require_run()
    return _metrics.unsupervised_clustering_scores(
        self._factors_t[:, factor_index], self._z_mean,
        random_state=self.seed)

  def relative_disentanglement_strength(self, method: str = "spearman"
                                        ) -> float:
    self._require_run()
    return _metrics.relative_strength(self.correlation_matrix(method))

  def correlation_matrix(self, method: str = "spearman") -> torch.Tensor:
    self._require_run()
    return _metrics.correlation_matrix(
        self._z_mean, torch.as_tensor(self.groundtruth.factors_original).to(
            self.device), method=method, seed=self.seed)

  def total_correlation(self) -> float:
    """The Gaussian minibatch TC of the aggregate posterior at the
    posterior means, over ``_CHUNK`` rows at a time (the pairwise terms of
    10,000 rows would take 4 GB at once)."""
    self._require_run()
    z = self._z_mean
    total = sum(float(_tc(z[i:i + _CHUNK], self.qz)) * len(z[i:i + _CHUNK])
                for i in range(0, z.shape[0], _CHUNK))
    return total / z.shape[0]

  def elbo(self) -> float:
    return float(torch.mean(self.log_likelihood_values() -
                            self.kl_divergence_values()))

  def log_likelihood_values(self) -> torch.Tensor:
    self._require_run()
    if self._llk_total is not None:
      return self._llk_total
    return self.px.log_prob(torch.as_tensor(self.x_true).to(self.device))

  def log_likelihood(self) -> float:
    return float(torch.mean(self.log_likelihood_values()))

  def kl_divergence_values(self) -> torch.Tensor:
    """Per-sample total KL: the model's own ``elbo_components`` terms
    collected by ``run_model``; where the objective needed labels, the
    single-point estimate log q(z̄) - log p(z̄) at the posterior means."""
    self._require_run()
    if self._kl_total is not None:
      return self._kl_total
    if self.model.latents_prior is None:
      return torch.zeros(len(self._z_mean), device=self.device)
    prior = self.model._prior_on(self.device)
    return self.qz.log_prob(self._z_mean) - prior.log_prob(self._z_mean)

  def kl_divergence(self) -> float:
    return float(torch.mean(self.kl_divergence_values()))

  def kl_unweighted_values(self) -> torch.Tensor:
    """Per-sample unweighted analytic KL(q(z|x) || p(z)) of the top
    latents: the rate published tables report (``kl_divergence`` is the
    objective's term, beta-scaled for the BetaVAE family).  Without an
    analytic KL for the pair, a 10-sample estimate from a generator seeded
    `seed` (``kl_unweighted_estimator`` says which)."""
    self._require_run()
    if self.model.latents_prior is None:
      return torch.zeros(len(self._z_mean), device=self.device)
    prior = self.model._prior_on(self.device)
    if kl_registry_lookup(type(self.qz), type(prior)) is not None:
      self.kl_unweighted_estimator = "analytic"
      return kl_divergence(self.qz, prior, analytic=True)
    warnings.warn(
        f"no analytic KL registered for ({type(self.qz).__name__}, "
        f"{type(prior).__name__}); kl_unweighted falls back to a 10-sample "
        "MC estimate", stacklevel=2)
    self.kl_unweighted_estimator = "mc10"
    return kl_divergence(self.qz, prior, q_sample=10,
                         generator=torch.Generator(self.device).manual_seed(
                             self.seed))

  def kl_unweighted(self) -> float:
    return float(torch.mean(self.kl_unweighted_values()))

  def elbo_unweighted(self) -> float:
    """llk - the unweighted KL: the beta = 1 ELBO the literature
    reports."""
    return (float(torch.mean(self.log_likelihood_values())) -
            float(torch.mean(self.kl_unweighted_values())))

  def accuracy_score(self) -> float:
    """Test accuracy of a logistic probe from the latents to the first
    factor."""
    self._require_run()
    xtr, xte, ytr, yte = train_test_split(
        self._z_mean, self._factors_t[:, 0], test_size=0.2,
        random_state=self.seed)
    return LogisticRegression().fit(xtr, ytr).score(xte, yte)

  def active_units(self, threshold: float = 1e-2) -> np.ndarray:
    """Latents whose posterior means vary more than `threshold` (Burda et
    al.), as host indices."""
    self._require_run()
    var = torch.var(self._z_mean.to(torch.float64), dim=0, correction=0)
    return torch.nonzero(var > threshold).reshape(-1).cpu().numpy()

  def frechet_inception_distance(self, features_fn=None) -> float:
    """FID between the reconstructions and the data.  Without inception
    weights, `features_fn` defaults to the model's encoder mean latents
    (the reconstructions encoded ``4 * _CHUNK`` at a time)."""
    self._require_run()
    recon = self.px.mean()
    if features_fn is None:
      f_real = self._z_mean
      step = 4 * _CHUNK
      with torch.no_grad():
        f_fake = torch.cat([self.model.encode(recon[i:i + step]).mean()
                            for i in range(0, len(recon), step)])
    else:
      f_real = features_fn(self.x_true)
      f_fake = features_fn(recon)
    return _fid(f_real, f_fake)

  # -- plots ------------------------------------------------------------------
  def _plot_data_reconstruction(self, n: int):
    """(the first n inputs, their reconstructions' means), on the host."""
    return self.x_true[:n], _host(self.px.mean()[:n])

  def plot_reconstruction(self, n: int = 16, path: Optional[str] = None):
    """Inputs over their reconstructions."""
    self._require_run()
    orig, recon = self._plot_data_reconstruction(n)
    plt = _pyplot()
    cols = int(np.ceil(np.sqrt(n)))
    fig, axes = plt.subplots(2 * int(np.ceil(n / cols)), cols,
                             figsize=(cols * 1.4, 2.8 * np.ceil(n / cols)))
    axes = np.atleast_2d(axes)
    for i in range(n):
      r, c = divmod(i, cols)
      for k, img in ((2 * r, orig[i]), (2 * r + 1, recon[i])):
        ax = axes[k][c]
        ax.imshow(img.squeeze(), cmap="gray" if img.shape[-1] == 1 else None)
        ax.axis("off")
    fig.tight_layout()
    return _finish(fig, path)

  @torch.no_grad()
  def _plot_data_latents_traverse(self, n_points: int, n_latents: int,
                                  seed: int):
    """The decoded traversal (n_latents, n_points, *image), on the host."""
    px = self.model.sample_traverse(self.x_true[:1],
                                    feature_indices=list(range(n_latents)),
                                    n_traverse_points=n_points, seed=seed)
    return _host(px.mean()).reshape(n_latents, n_points,
                                    *self.x_true.shape[1:])

  def plot_latents_traverse(self, n_points: int = 11, n_latents: int = None,
                            path: Optional[str] = None, seed: int = 1):
    """A grid of decodes, each row one latent swept from -2 to 2 around the
    first input's posterior mean."""
    self._require_run()
    n_latents = n_latents or min(self._z_mean.shape[1], 10)
    imgs = self._plot_data_latents_traverse(n_points, n_latents, seed)
    plt = _pyplot()
    fig, axes = plt.subplots(n_latents, n_points,
                             figsize=(n_points * 1.1, n_latents * 1.1))
    axes = np.atleast_2d(axes)
    for i in range(n_latents):
      for j in range(n_points):
        axes[i][j].imshow(imgs[i, j].squeeze(), cmap="gray")
        axes[i][j].axis("off")
    fig.tight_layout()
    return _finish(fig, path)

  def _plot_data_latents_tsne(self, factor_index: int):
    """(the 2-D t-SNE of the posterior means, the factor's labels), on the
    host."""
    z2 = TSNE(n_components=2, random_state=self.seed,
              perplexity=min(30, len(self._z_mean) - 1)).fit_transform(
                  self._z_mean)
    return _host(z2), self.groundtruth.factors[:, factor_index]

  def plot_latents_tsne(self, factor_index: int = 0,
                        path: Optional[str] = None):
    """The 2-D t-SNE of the posterior means, coloured by a factor."""
    self._require_run()
    z2, colors = self._plot_data_latents_tsne(factor_index)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 5))
    sc = ax.scatter(z2[:, 0], z2[:, 1], s=4, c=colors, cmap="tab10")
    fig.colorbar(sc)
    return _finish(fig, path)

  def _plot_data_correlation(self, method: str) -> np.ndarray:
    """The latent-factor correlation matrix, its rows aligned to put each
    factor's best latent on the diagonal, on the host."""
    mat = _host(self.correlation_matrix(method=method))
    return mat[diagonal_linear_assignment(np.abs(mat))]

  def plot_correlation(self, method: str = "spearman",
                       path: Optional[str] = None):
    """The aligned latent-factor correlation heatmap."""
    self._require_run()
    mat = self._plot_data_correlation(method)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(mat, cmap="RdBu_r", vmin=-1, vmax=1, aspect="auto")
    ax.set_xticks(range(len(self.groundtruth.factor_names)))
    ax.set_xticklabels(self.groundtruth.factor_names, rotation=45)
    ax.set_ylabel("latents (aligned)")
    fig.colorbar(im)
    return _finish(fig, path)

  def _plot_data_histogram(self, n_bins: int):
    """Each latent's histogram of its posterior means: (counts, edges)."""
    return _histograms(self._z_mean, n_bins)

  def plot_histogram(self, n_bins: int = 40, path: Optional[str] = None):
    """Each latent's density histogram with a standard-normal overlay."""
    self._require_run()
    counts, edges = self._plot_data_histogram(n_bins)
    plt = _pyplot()
    D = len(counts)
    cols = int(np.ceil(np.sqrt(D)))
    rows = int(np.ceil(D / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 2.2, rows * 1.8))
    axes = np.atleast_1d(axes).ravel()
    grid = np.linspace(-3.5, 3.5, 200)
    normal = np.exp(-0.5 * grid ** 2) / np.sqrt(2 * np.pi)
    for i in range(D):
      ax = axes[i]
      _stairs(ax, counts[i], edges[i], alpha=0.7)
      ax.plot(grid, normal, lw=1.0, color="crimson")
      ax.set_title(f"z{i}", fontsize=8)
      ax.tick_params(labelsize=6)
    for ax in axes[D:]:
      ax.axis("off")
    fig.tight_layout()
    return _finish(fig, path)

  @torch.no_grad()
  def _plot_data_distortion(self):
    """(mean, std) over the samples of each pixel's −log p(x|z), (H, W, C),
    on the host."""
    base = getattr(self.px, "distribution", self.px)
    x = torch.as_tensor(self.x_true, dtype=torch.float32).to(self.device)
    nll = -base.log_prob(x)
    if nll.ndim < 3:  # vector data: nothing spatial to draw
      nll = nll.reshape(nll.shape[0], -1, 1, 1)
    if nll.ndim == 3:
      nll = nll[..., None]
    return _host(nll.mean(0)), _host(nll.std(0, correction=0))

  def plot_distortion(self, path: Optional[str] = None, title: str = ""):
    """Per-pixel mean and std heatmaps of −log p(x|z): where the decoder
    spends its distortion."""
    self._require_run()
    mean, std = self._plot_data_distortion()
    plt = _pyplot()
    C = mean.shape[-1]
    fig, axes = plt.subplots(C, 2, figsize=(5, 2.2 * C), squeeze=False)
    for c in range(C):
      for j, (img, lab) in enumerate(((mean, "mean -log p(x|z)"),
                                      (std, "std"))):
        ax = axes[c][j]
        im = ax.pcolormesh(img[..., c], cmap="Spectral", rasterized=True)
        ax.invert_yaxis()
        ax.axis("off")
        ax.set_title(f"{lab} ch{c}", fontsize=7)
        fig.colorbar(im, ax=ax, fraction=0.04, pad=0.02)
    if title:
      fig.suptitle(title, fontsize=9)
    fig.tight_layout()
    return _finish(fig, path)

  def _plot_data_latents_stats(self):
    """Per latent, sorted by stddev: the mean and stddev of the posterior
    and the mean analytic KL to N(0, 1), on the host."""
    mu = _reshape2D(self.qz.mean()).to(torch.float32)
    sd = _reshape2D(self.qz.stddev()).to(torch.float32)
    mean, stddev = mu.mean(0), sd.mean(0)
    kld = (0.5 * (mu ** 2 + sd ** 2 - 1.0 - 2.0 * torch.log(sd))).mean(0)
    ids = torch.argsort(stddev, stable=True)
    return _host(mean[ids]), _host(stddev[ids]), _host(kld[ids])

  def plot_latents_stats(self, path: Optional[str] = None, title: str = ""):
    """Per-latent posterior statistics sorted by stddev, with the KL to the
    standard-normal prior."""
    self._require_run()
    mean, stddev, kld = self._plot_data_latents_stats()
    fig = plot_latent_stats(mean, stddev, kld=kld)
    if title:
      fig.axes[0].set_title(title, fontsize=9)
    return _finish(fig, path)

  @torch.no_grad()
  def _plot_data_interpolation(self, i: int, j: int, n_points: int):
    """The decodes of the latent segment between two inputs' posterior
    means (n_points, *image), on the host."""
    za = self._z_mean[i].to(torch.float64)
    zb = self._z_mean[j].to(torch.float64)
    ts = torch.as_tensor(np.linspace(0.0, 1.0, n_points)).to(za.device)[:, None]
    zs = ((1 - ts) * za[None] + ts * zb[None]).to(torch.float32)
    return _host(self.model.decode(zs).mean())

  def plot_interpolation(self, i: int = 0, j: int = 1, n_points: int = 10,
                         path: Optional[str] = None):
    """Decodes along the latent segment between two test inputs."""
    self._require_run()
    imgs = self._plot_data_interpolation(i, j, n_points)
    plt = _pyplot()
    fig, axes = plt.subplots(1, n_points, figsize=(n_points * 1.3, 1.6))
    for k in range(n_points):
      axes[k].imshow(imgs[k].squeeze(), cmap="gray")
      axes[k].axis("off")
    fig.tight_layout()
    return _finish(fig, path)

  @torch.no_grad()
  def _plot_data_prior_sampling(self, n: int, z=None):
    """The decodes of n draws from the prior (drawn from a generator seeded
    `seed`, or `z` given), on the host."""
    if z is None:
      z = self.model.sample_prior(n, seed=self.seed)
    return _host(self.model.decode(z).mean())

  def plot_prior_sampling(self, n: int = 16, path: Optional[str] = None):
    """Decodes of prior samples z ~ p(z)."""
    imgs = self._plot_data_prior_sampling(n)
    plt = _pyplot()
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 1.4, rows * 1.4))
    axes = np.atleast_1d(axes).ravel()
    for k in range(n):
      axes[k].imshow(imgs[k].squeeze(), cmap="gray")
      axes[k].axis("off")
    for ax in axes[n:]:
      ax.axis("off")
    fig.tight_layout()
    return _finish(fig, path)

  def _plot_data_pairwise_scatter(self, factor_index: int, max_latents: int):
    """(the first latents' posterior means, the factor's labels or None,
    each latent's 30-bin histogram (counts, edges)), on the host."""
    z = self._z_mean[:, :max_latents]
    colors = self.groundtruth.factors[:, factor_index] \
        if self.groundtruth else None
    return _host(z), colors, _histograms(z, 30)

  def plot_pairwise_scatter(self, factor_index: int = 0,
                            max_latents: int = 6,
                            path: Optional[str] = None):
    """The pairwise scatter matrix of the first latents, coloured by a
    factor, with each latent's histogram on the diagonal."""
    self._require_run()
    z, c, (counts, edges) = self._plot_data_pairwise_scatter(factor_index,
                                                             max_latents)
    plt = _pyplot()
    D = z.shape[1]
    fig, axes = plt.subplots(D, D, figsize=(D * 1.6, D * 1.6))
    axes = np.atleast_2d(axes)
    for a in range(D):
      for b in range(D):
        ax = axes[a][b]
        if a == b:
          _stairs(ax, counts[a], edges[a], alpha=0.7)
        else:
          ax.scatter(z[:, b], z[:, a], s=2, c=c, cmap="tab10", alpha=0.6)
        ax.tick_params(labelsize=5)
    fig.tight_layout()
    return _finish(fig, path)

  # -- report -------------------------------------------------------------------
  def write_report(self, path: Optional[str] = None,
                   scores: Sequence[str] = ("elbo", "llk", "kl", "mig",
                                            "sap", "dci", "betavae",
                                            "factorvae", "tc",
                                            "active_units"),
                   verbose: bool = False) -> Dict[str, float]:
    """Compute a suite of scores and optionally write them to a text file.
    As in the JAX package, a score that raises is reported as
    ``<score>_error`` and the others go on (`verbose` re-raises)."""
    self._require_run()
    out: Dict[str, Any] = {}
    for s in scores:
      try:
        if s == "elbo":
          out["elbo"] = self.elbo()
        elif s == "llk":
          out["log_likelihood"] = self.log_likelihood()
        elif s == "kl":
          out["kl_divergence"] = self.kl_divergence()
          out["kl_unweighted"] = self.kl_unweighted()
          out["elbo_unweighted"] = self.elbo_unweighted()
        elif s == "mig":
          out["mig"] = self.mig_score()
        elif s == "sap":
          out["sap"] = self.sap_score()
        elif s == "dci":
          d, c, i = self.dci_score()
          out.update(dci_disentanglement=d, dci_completeness=c,
                     dci_informativeness=i)
        elif s == "betavae":
          out["betavae_score"] = self.betavae_score()
        elif s == "factorvae":
          out["factorvae_score"] = self.factorvae_score()
        elif s == "tc":
          out["total_correlation"] = self.total_correlation()
        elif s == "active_units":
          out["n_active_units"] = int(len(self.active_units()))
        elif s == "fid":
          out["fid"] = self.frechet_inception_distance()
        elif s == "clustering":
          out.update({f"clustering_{k}": v
                      for k, v in self.clustering_score().items()})
      except Exception as e:  # the report goes on; the error is its entry
        out[f"{s}_error"] = str(e)
        if verbose:
          raise
    if path is not None:
      with open(path, "w") as f:
        for k, v in out.items():
          f.write(f"{k}: {v}\n")
    return out

