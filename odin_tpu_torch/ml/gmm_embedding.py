"""GMM label embedding and classification of the port (PyTorch port of
``odin_tpu/ml/gmm_embedding.py``), on the port's ``GaussianMixture``
(``ml/mixture.py``) on the device of the input (the card for an array
unless `device` says otherwise).

- ``ProbabilisticEmbedding`` fits one 1-D diagonal mixture per column, all
  columns at once (``GaussianMixture.fit_batch``), and gives each score
  the responsibility of its column's highest-mean component; as in JAX,
  ``positive_component`` is accepted and ignored.  Its diagnostic plots
  are the JAX package's, drawn on the host.
- ``GMMclassifier`` fits one mixture per class with
  ``min(n_components, max(count // 2, 1))`` components (classes of equal
  count are fitted together) and classifies by the largest
  class-conditional log-likelihood plus the log prior.
- ``GMMThreshold`` places a threshold between the two highest-mean
  components of a 1-D mixture, at the precision-weighted midpoint.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from odin_tpu_torch.device import as_tensor, device_of
from odin_tpu_torch.ml.base import Evaluable
from odin_tpu_torch.ml.mixture import GaussianMixture

__all__ = ["ProbabilisticEmbedding", "GMMclassifier", "GMMThreshold"]

F64 = torch.float64


def _host(x) -> np.ndarray:
  return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
      np.asarray(x)


class ProbabilisticEmbedding:
  """One 2-component (by default) diagonal GMM per output dimension;
  scores become the responsibility of the highest-mean component."""

  def __init__(self, n_components_per_class: int = 2,
               positive_component: int = -1, random_state: int = 1,
               device=None):
    self.n_components = int(n_components_per_class)
    self.random_state = int(random_state)
    self.device = device
    self._gmm: Optional[GaussianMixture] = None

  def _input(self, X) -> torch.Tensor:
    dev = self._gmm._means.device if self._gmm is not None else \
        device_of(X, device=self.device)
    X = as_tensor(X, dev, F64)
    return X[:, None] if X.ndim == 1 else X

  def fit(self, pos) -> "ProbabilisticEmbedding":
    X = self._input(pos)
    self._gmm = GaussianMixture(self.n_components, covariance_type="diag",
                                random_state=self.random_state,
                                device=X.device)
    self._gmm.fit_batch(X.T[:, :, None].contiguous())
    return self

  @property
  def _gmms(self) -> List[GaussianMixture]:
    """One unbatched ``GaussianMixture`` per column (a view of the batched
    fit)."""
    g = self._gmm
    return [GaussianMixture(self.n_components, covariance_type="diag"
                            ).set_state(g._weights[i], g._means[i],
                                        g._covariances[i], g._prec_chol[i])
            for i in range(g._weights.shape[0])]

  def predict_proba(self, pos) -> torch.Tensor:
    """P(positive) per dimension: the responsibility of the column's
    highest-mean component."""
    X = self._input(pos)
    resp = self._gmm.predict_proba(X.T[:, :, None].contiguous())  # (B,n,K)
    top = torch.argmax(self._gmm._means[:, :, 0], dim=1)
    return resp.gather(2, top[:, None, None].expand(-1, resp.shape[1], 1)
                       )[:, :, 0].T

  def binarize(self, pos, threshold: float = 0.5) -> torch.Tensor:
    return (self.predict_proba(pos) > threshold).to(torch.int64)

  transform = predict_proba

  def fit_transform(self, x) -> torch.Tensor:
    return self.fit(x).predict_proba(x)

  # -- diagnostics, drawn on the host ------------------------------------------
  def _check_input(self, X, labels):
    X = np.atleast_2d(_host(X).astype(np.float64))
    n = X.shape[1]
    k = self._gmm._weights.shape[0]
    assert n == k, f"fitted with {k} dims but given {n}"
    if labels is None:
      labels = [f"#{i}" for i in range(n)]
    assert len(labels) == n, "labels/dimensions mismatch"
    return X, list(labels), n

  def plot_diagnosis(self, X, labels=None, n_bins: int = 120):
    """Per dimension: the histogram, the fitted mixture's density, each
    component's bell and the positive region shaded."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy import stats as sp_stats
    X, labels, n = self._check_input(X, labels)
    fig, axes = plt.subplots(n, 1, figsize=(8, 2.2 * n), squeeze=False)
    for i, (ax, name, gmm) in enumerate(zip(axes[:, 0], labels, self._gmms)):
      x = X[:, i]
      count, bins, _ = ax.hist(x, bins=n_bins, alpha=0.4, color="gray")
      grid = np.linspace(bins[0], bins[-1], 600)[:, None]
      pdf = np.exp(_host(gmm.score_samples(grid)))
      pdf = pdf / max(pdf.max(), 1e-12) * max(count.max(), 1)
      ax.plot(grid.ravel(), pdf, "r-", lw=1.5, alpha=0.7)
      llk = gmm.score(x[:, None])
      ax.set_title(f"[{name}] LLK:{llk:.2f} BIC:{gmm.bic(x[:, None]):.2f} "
                   f"AIC:{gmm.aic(x[:, None]):.2f}", fontsize=8)
      means = _host(gmm.means_).ravel()
      stds = np.sqrt(_host(gmm.covariances_).ravel())
      tw = ax.twinx()
      for m, s in zip(means, stds):
        tw.plot(grid.ravel(), sp_stats.norm.pdf(grid.ravel(), m, s),
                lw=1.0, alpha=0.8)
      tw.set_yticks([])
      top = int(np.argmax(means))
      resp = _host(gmm.predict_proba(grid))[:, top]
      pos = resp > 0.5
      if pos.any():
        ax.fill_between(grid.ravel(), 0, max(count.max(), 1), where=pos,
                        alpha=0.15, color="green")
        ax.text(grid.ravel()[pos][0], 0, f"{grid.ravel()[pos][0]:.2f}",
                fontsize=7)
    fig.tight_layout()
    self.add_figure("diagnosis", fig)
    return self

  def plot_distribution(self, X, labels=None):
    """Column sums of the raw, binarized and probabilized scores."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    X, labels, n = self._check_input(X, labels)
    norm01 = lambda v: v / max(np.sum(v), 1e-12)
    dist_raw = norm01(np.sum(X, axis=0))
    dist_bin = norm01(np.sum(_host(self.binarize(X)), axis=0))
    dist_prob = norm01(np.sum(_host(self.predict_proba(X)), axis=0))
    x = np.arange(n)
    fig, ax = plt.subplots(figsize=(max(1.2 * n, 4), 3))
    b1 = ax.bar(x, dist_raw, width=0.2, alpha=0.8)
    b2 = ax.bar(x + 0.2, dist_bin, width=0.2, alpha=0.8)
    b3 = ax.bar(x + 0.4, dist_prob, width=0.2, alpha=0.8)
    ax.set_xticks(x + 0.2)
    ax.set_xticklabels(labels, rotation=-10)
    ax.legend([b1, b2, b3], ["Original", "Binarized", "Probabilized"],
              fontsize=7)
    ax.grid(True, axis="y")
    ax.set_axisbelow(True)
    fig.tight_layout()
    self.add_figure("distribution", fig)
    return self

  def boxplot(self, X, labels=None):
    """Per dimension, boxplots of the original and the non-zero values."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    X, labels, n = self._check_input(X, labels)
    fig, axes = plt.subplots(n, 2, figsize=(5, 2.0 * n), squeeze=False)
    for i, name in enumerate(labels):
      x = X[:, i]
      axes[i, 0].boxplot(x, whis=1.5, showmeans=True, meanline=True,
                         flierprops={"marker": ".", "markersize": 6})
      axes[i, 0].set_ylabel(name)
      axes[i, 0].set_xticklabels(["Original"])
      nz = x[x > 0]
      axes[i, 1].boxplot(nz if nz.size else x, whis=1.5, showmeans=True,
                         meanline=True,
                         flierprops={"marker": ".", "markersize": 6})
      axes[i, 1].set_xticklabels(["NonZeros"])
    fig.tight_layout()
    self.add_figure("boxplot", fig)
    return self

  def add_figure(self, name, fig):
    if not hasattr(self, "_figures"):
      self._figures = {}
    self._figures[name] = fig
    return self

  def save_figures(self, path: str = "figures.pdf", clear: bool = True):
    from odin_tpu_torch.visual import plot_save
    out = plot_save(path, figs=list(getattr(self, "_figures", {}).values()),
                    clear_all=False)
    if clear:
      self._figures = {}
    return out


class GMMclassifier(Evaluable):
  """One GMM per class; the class of the largest class-conditional
  log-likelihood plus log prior."""

  @property
  def labels(self):
    return [str(c) for c in (self.classes_ if self.classes_ is not None
                             else [])]

  def __init__(self, n_components: int = 2, covariance_type: str = "diag",
               random_state: int = 1, device=None):
    self.n_components = int(n_components)
    self.covariance_type = covariance_type
    self.random_state = int(random_state)
    self.device = device
    self.classes_: Optional[np.ndarray] = None
    self._gmms: List[GaussianMixture] = []
    self._priors: Optional[torch.Tensor] = None

  def fit(self, X, y) -> "GMMclassifier":
    X = as_tensor(X, device_of(X, device=self.device))
    if X.dtype not in (torch.float32, F64):
      X = X.to(F64)
    y = _host(y).ravel()
    self.classes_ = np.unique(y)
    counts = np.array([(y == c).sum() for c in self.classes_])
    self._gmms = [None] * len(self.classes_)
    # classes with the same count (hence the same component count) are
    # fitted together, each mixture from its own k-means
    for count in np.unique(counts):
      group = np.flatnonzero(counts == count)
      k = min(self.n_components, max(int(count) // 2, 1))
      rows = torch.stack([
          X[torch.as_tensor(np.flatnonzero(y == self.classes_[i]),
                            device=X.device)] for i in group])
      batch = GaussianMixture(k, covariance_type=self.covariance_type,
                              random_state=self.random_state,
                              device=X.device).fit_batch(rows)
      for j, i in enumerate(group):
        g = GaussianMixture(k, covariance_type=self.covariance_type)
        self._gmms[i] = g.set_state(
            batch._weights[j], batch._means[j], batch._covariances[j],
            batch._prec_chol[j])
    self._priors = torch.log(torch.as_tensor(counts / len(y), dtype=F64,
                                             device=X.device))
    return self

  def decision_function(self, X) -> torch.Tensor:
    return torch.stack([g.score_samples(X).to(F64) for g in self._gmms],
                       -1) + self._priors[None, :]

  def predict(self, X) -> np.ndarray:
    return self.classes_[_host(torch.argmax(self.decision_function(X), -1))]

  def predict_proba(self, X) -> torch.Tensor:
    ll = self.decision_function(X)
    ll = ll - ll.max(-1, keepdim=True).values
    p = torch.exp(ll)
    return p / p.sum(-1, keepdim=True)


class GMMThreshold:
  """A 1-D GMM's decision threshold between its two highest-mean modes,
  at their precision-weighted midpoint."""

  def __init__(self, n_components: int = 2, random_state: int = 1,
               device=None):
    self.n_components = int(n_components)
    self.random_state = int(random_state)
    self.device = device
    self.threshold_: float = 0.0

  def fit(self, x) -> "GMMThreshold":
    x = as_tensor(x, device_of(x, device=self.device), F64).reshape(-1, 1)
    self.device_ = x.device
    self.gmm_ = GaussianMixture(self.n_components, covariance_type="diag",
                                random_state=self.random_state,
                                device=x.device).fit(x)
    means = _host(self.gmm_.means_).ravel()
    cov = _host(self.gmm_.covariances_).ravel()
    order = np.argsort(means)
    hi, lo = order[-1], order[-2] if len(order) > 1 else order[-1]
    m1, m2 = means[lo], means[hi]
    s1, s2 = np.sqrt(cov[lo]), np.sqrt(cov[hi])
    self.threshold_ = float((m1 * s2 + m2 * s1) / (s1 + s2))
    return self

  def predict(self, x) -> torch.Tensor:
    x = as_tensor(x, self.device_)
    return (x.reshape(-1) > self.threshold_).to(torch.int64)
