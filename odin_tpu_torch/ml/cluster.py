"""Clustering of the port (PyTorch port of ``odin_tpu/ml/cluster.py``), on
the device of its inputs (the card for arrays unless ``device='cpu'``):
``KMeansJax``, ``fast_kmeans``, ``fast_knn``, ``fast_dbscan``,
``dbscan_predict`` and ``fast_naive_bayes``, with scikit-learn 1.9's
``KMeans`` and ``DBSCAN`` carried in torch (the card's machine has no
scikit-learn).

``KMeansJax`` is the JAX package's Lloyd iteration: ``|x|² − 2x·cᵀ + |c|²``,
the argmin, the members' means (float32 centres), and a stop when no centre
moves by ``tol``.  The distances are float64 where JAX's are float32: a
float32 matmul's rounding depends on its summation order, which differs
between the card, the CPU and XLA, and moves a row within about 1e-6 of a
tie to the other centre; in float64 the card and the CPU give one answer,
JAX's away from such rows.  Its k-means++ seeding draws the same
``RandomState`` calls as the JAX package's (``randint``, then one
``choice(n, p=d²/Σd²)`` a centre), but keeps each row's squared distance to
its nearest centre on the device as a running minimum (O(n·k·d) in all,
where the JAX package recomputes every centre each step; each distance
summed in float64 and rounded to float32), and makes each ``choice``
there: ``p`` in float32, its float64 cumulative sum, normalised, searched
with the uniform the host's ``random_sample`` draws, which is what
``RandomState.choice`` does.

``KMeans`` follows ``sklearn/cluster/_kmeans.py``: the data centred on its
mean, greedy k-means++ (``2 + int(log k)`` trials a centre, the trials'
cumulative potential summed on the host in the data's dtype, as numpy's
``cumsum`` sums it), Lloyd's iterations to ``max_iter`` with the strict and
the ``tol`` (times the mean feature variance) stops, empty clusters
relocated to the farthest rows, a last E-step, and the best of ``n_init``
runs drawn from one ``RandomState``.  The seeding distances are float64,
rounded to the data's dtype.  The centres are in the data's dtype, the
members' sums made in float64 and rounded, times the reciprocal of the
count, as scikit-learn computes them.  Lloyd's distances of one feature are
in the data's dtype, which reproduces scikit-learn's rounding exactly (ties
between centres are common there: a discretized column); of several, in
float64 (``_labels``), so a row within float32 rounding of a tie may take
another centre than scikit-learn's.

``DBSCAN`` counts each row's neighbours within ``eps`` (itself included,
the squared distance summed feature by feature in float64 as scikit-learn's
KD-tree sums it), labels the connected components of the core rows by
min-label propagation with pointer jumping, numbers them by their
lowest-index core (the order of scikit-learn's ``dbscan_inner``), and gives
a border row the smallest cluster number among its core neighbours (the
cluster whose search reaches it first).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from odin_tpu_torch.device import as_tensor, device_of
from odin_tpu_torch.ml.gmm_tmat import ieee_fp32_matmuls
from odin_tpu_torch.ml.naive_bayes import fast_naive_bayes
from odin_tpu_torch.ml.neighbors import (KNeighborsClassifier,
                                         NearestNeighbors, row_chunks,
                                         sq_distances, sqrt_rn)

__all__ = ["KMeansJax", "KMeans", "DBSCAN", "fast_kmeans", "fast_knn",
           "fast_dbscan", "dbscan_predict", "fast_naive_bayes"]


def _float_tensor(X, device) -> torch.Tensor:
  X = as_tensor(X, device_of(X, device=device))
  return X if X.dtype in (torch.float32, torch.float64) else X.to(
      torch.float64)


def _nearest(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
  """Each row's nearest centre (int64), from float64 squared distances,
  the first of equal ones."""
  return torch.cat([torch.argmin(sq_distances(X[rows], centers), dim=1)
                    for rows in row_chunks(X.shape[0], centers.shape[0],
                                           X.shape[1])])


# ---------------------------------------------------------------------------
# the JAX package's k-means
# ---------------------------------------------------------------------------
class KMeansJax:
  """Lloyd's algorithm with k-means++ seeding, on the device of X."""

  def __init__(self, n_clusters: int = 8, n_iter: int = 50, tol: float = 1e-5,
               random_state: int = 1, device=None):
    self.n_clusters = int(n_clusters)
    self.n_iter = int(n_iter)
    self.tol = float(tol)
    self.random_state = int(random_state)
    self.device = device
    self.cluster_centers_: Optional[torch.Tensor] = None

  def _init_centers(self, X: torch.Tensor, rng: np.random.RandomState
                    ) -> torch.Tensor:
    n = X.shape[0]
    first = int(rng.randint(n))
    d2 = _sq_to_row(X, X[first])
    chosen = torch.empty(self.n_clusters, dtype=torch.int64, device=X.device)
    chosen[0] = first
    for c in range(1, self.n_clusters):
      total = d2.to(torch.float64).sum().to(torch.float32)
      p = d2 / torch.clamp(total, min=1e-12)
      cdf = torch.cumsum(p.to(torch.float64), 0)
      u = torch.tensor([rng.random_sample()], dtype=torch.float64,
                       device=X.device)
      pick = torch.searchsorted(cdf / cdf[-1], u, right=True)
      chosen[c] = pick[0]
      d2 = torch.minimum(d2, _sq_to_row(X, X[pick[0]]))
    self.seed_indices_ = chosen
    return X[chosen].clone()

  def fit(self, X) -> "KMeansJax":
    X = as_tensor(X, device_of(X, device=self.device), torch.float32)
    rng = np.random.RandomState(self.random_state)
    centers = self._init_centers(X, rng)
    x64 = X.to(torch.float64)
    x_sq = (x64 * x64).sum(1)
    self._inertias = []
    self.n_iter_ = 0
    for _ in range(self.n_iter):
      assign = self._assign(x64, x_sq, centers)
      counts = torch.bincount(assign, minlength=self.n_clusters)
      sums = torch.zeros(self.n_clusters, X.shape[1], dtype=torch.float64,
                         device=X.device).index_add_(0, assign, x64)
      new = (sums / counts.clamp(min=1)[:, None]).to(torch.float32)
      new = torch.where(counts[:, None] > 0, new, centers)
      self._inertias.append(_inertia(X, centers, assign))
      self._last_centers = centers
      self.n_iter_ += 1
      moved = float(torch.max(torch.abs(new - centers)))
      centers = new
      if moved < self.tol:
        break
    self.cluster_centers_ = centers
    self.labels_ = assign
    return self

  @staticmethod
  def _assign(x64, x_sq, centers) -> torch.Tensor:
    c64 = centers.to(torch.float64)
    c_sq = (c64 * c64).sum(1)
    return torch.cat([
        torch.argmin(x_sq[rows, None] - 2.0 * (x64[rows] @ c64.T) +
                     c_sq[None], dim=1)
        for rows in row_chunks(x64.shape[0], centers.shape[0])])

  def predict(self, X) -> torch.Tensor:
    X = as_tensor(X, self.cluster_centers_.device, torch.float32)
    return _nearest(X, self.cluster_centers_)

  def fit_predict(self, X) -> torch.Tensor:
    return self.fit(X).labels_

  def transform(self, X) -> torch.Tensor:
    """Each row's distance to each centre (float32)."""
    X = as_tensor(X, self.cluster_centers_.device, torch.float32)
    return torch.cat([torch.sqrt(sq_distances(X[rows],
                                              self.cluster_centers_))
                      for rows in row_chunks(X.shape[0], self.n_clusters,
                                             X.shape[1])]).to(torch.float32)


def _sq_to_row(X: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
  """Each row's squared distance to `row`, summed in float64 and rounded
  to X's dtype (so the card and the CPU agree to the rounding)."""
  out = torch.empty(X.shape[0], dtype=X.dtype, device=X.device)
  r64 = row.to(torch.float64)
  for rows in row_chunks(X.shape[0], X.shape[1]):
    diff = X[rows].to(torch.float64) - r64
    out[rows] = (diff * diff).sum(1).to(X.dtype)
  return out


def _inertia(X: torch.Tensor, centers: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
  """Σ ‖x − c_label‖² in float64 (a tensor on the device)."""
  total = torch.zeros((), dtype=torch.float64, device=X.device)
  for rows in row_chunks(X.shape[0], X.shape[1]):
    diff = X[rows].to(torch.float64) - centers[labels[rows]].to(torch.float64)
    total = total + (diff * diff).sum()
  return total


# ---------------------------------------------------------------------------
# scikit-learn's KMeans
# ---------------------------------------------------------------------------
class KMeans:
  """scikit-learn 1.9's ``KMeans`` (Lloyd, from k-means++ or an array of
  centres), unweighted, dense, on the device of X."""

  def __init__(self, n_clusters: int = 8, *, init="k-means++",
               n_init="auto", max_iter: int = 300, tol: float = 1e-4,
               random_state=None, algorithm: str = "lloyd", device=None):
    if algorithm != "lloyd" or (isinstance(init, str) and
                                init != "k-means++"):
      raise ValueError(f"only Lloyd's algorithm from 'k-means++' or an "
                       f"array is ported, got {algorithm!r}, {init!r}")
    self.n_clusters = int(n_clusters)
    self.init = init
    self.n_init = n_init
    self.max_iter = int(max_iter)
    self.tol = float(tol)
    self.random_state = random_state
    self.device = device

  # -- seeding ---------------------------------------------------------------
  @staticmethod
  def _sq_to(rows: torch.Tensor, X64: torch.Tensor, x_sq: torch.Tensor,
             dtype) -> torch.Tensor:
    """(len(rows), n) squared distances of scikit-learn's float64
    ``_euclidean_distances``, rounded to the data's dtype."""
    r = X64[rows]
    d = x_sq[rows][:, None] - 2.0 * (r @ X64.T) + x_sq[None]
    return torch.clamp(d, min=0.0).to(dtype)

  def _kmeans_plusplus(self, X: torch.Tensor, X64: torch.Tensor,
                       x_sq: torch.Tensor, rng: np.random.RandomState
                       ) -> torch.Tensor:
    n = X.shape[0]
    k = self.n_clusters
    np_dtype = np.float32 if X.dtype == torch.float32 else np.float64
    weight = np.ones(n, dtype=np_dtype)
    trials = 2 + int(np.log(k))
    indices = [int(rng.choice(n, p=weight / weight.sum()))]
    closest = self._sq_to(torch.tensor(indices, device=X.device), X64, x_sq,
                          X.dtype)[0]
    pot = closest.to(torch.float64).sum().to(X.dtype)
    for _ in range(1, k):
      rand_vals = rng.uniform(size=trials) * pot.cpu().numpy()
      cum = np.cumsum(weight * closest.cpu().numpy())
      cand = np.clip(np.searchsorted(cum, rand_vals), None, n - 1)
      cand_t = torch.as_tensor(cand, device=X.device)
      dist = torch.minimum(closest[None],
                           self._sq_to(cand_t, X64, x_sq, X.dtype))
      pots = dist.to(torch.float64).sum(1).to(X.dtype)
      best = int(torch.argmin(pots))
      pot, closest = pots[best], dist[best]
      indices.append(int(cand[best]))
    return X[torch.as_tensor(indices, device=X.device)].clone()

  def _init_centroids(self, X, X64, x_sq, rng) -> torch.Tensor:
    if isinstance(self.init, str):
      return self._kmeans_plusplus(X, X64, x_sq, rng)
    return self._init_array  # an array given: already centred

  # -- Lloyd -----------------------------------------------------------------
  def _labels(self, X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """scikit-learn's E-step, ``|c|² − 2x·cᵀ``, the first of equal minima.
    One feature makes one product an element, which the data's dtype
    rounds exactly as scikit-learn's gemm does; with several, its BLAS sums
    in an order no other matmul follows, so the sums are float64 (the same
    on the card and the CPU)."""
    dtype = X.dtype if X.shape[1] == 1 else torch.float64
    c = centers.to(dtype)
    c_sq = (c * c).sum(1)
    with ieee_fp32_matmuls():
      return torch.cat([
          torch.argmin(c_sq[None] - 2.0 * (X[rows].to(dtype) @ c.T), dim=1)
          for rows in row_chunks(X.shape[0], centers.shape[0])])

  def _lloyd(self, X: torch.Tensor, centers: torch.Tensor, tol: float):
    k = self.n_clusters
    X64 = X.to(torch.float64)
    labels_old = torch.full((X.shape[0],), -1, dtype=torch.int64,
                            device=X.device)
    strict = False
    for i in range(self.max_iter):
      labels = self._labels(X, centers)
      weight = torch.bincount(labels, minlength=k).to(X.dtype)
      sums = torch.zeros(k, X.shape[1], dtype=torch.float64,
                         device=X.device).index_add_(0, labels, X64)
      sums, weight = _relocate_empty(X, centers, sums.to(X.dtype), weight,
                                     labels)
      new = _average_centers(sums, weight)
      shift = torch.sqrt(((new.to(torch.float64) -
                           centers.to(torch.float64)) ** 2).sum(1)).to(
                               X.dtype)
      centers = new
      if torch.equal(labels, labels_old):
        strict = True
        break
      if float((shift.to(torch.float64) ** 2).sum()) <= tol:
        break
      labels_old = labels
    if not strict:
      labels = self._labels(X, centers)
    inertia = float(_inertia(X, centers, labels).to(X.dtype))
    return labels, inertia, centers, i + 1

  def fit(self, X, y=None, sample_weight=None) -> "KMeans":
    if sample_weight is not None:
      raise ValueError("sample_weight is not ported; every row weighs 1")
    X = _float_tensor(X, self.device)
    n = X.shape[0]
    if n < self.n_clusters:
      raise ValueError(f"n_samples={n} should be >= "
                       f"n_clusters={self.n_clusters}.")
    X64 = X.to(torch.float64)
    # _tolerance: the mean feature variance times tol
    tol = float(torch.var(X64, dim=0, correction=0).mean()) * self.tol \
        if self.tol else 0.0
    array_init = not isinstance(self.init, str)
    n_init = self.n_init
    if n_init == "auto" or array_init:
      n_init = 1
    rng = self.random_state if isinstance(
        self.random_state, np.random.RandomState) else \
        np.random.RandomState(self.random_state)
    mean = X64.mean(0).to(X.dtype)
    Xc = X - mean
    if array_init:
      self._init_array = as_tensor(self.init, X.device, X.dtype) - mean
    Xc64 = Xc.to(torch.float64)
    x_sq = (Xc64 * Xc64).sum(1)
    best = None
    for _ in range(int(n_init)):
      centers = self._init_centroids(Xc, Xc64, x_sq, rng)
      labels, inertia, centers, n_iter = self._lloyd(Xc, centers, tol)
      if best is None or (inertia < best[1] and not _same_clustering(
          labels, best[0], self.n_clusters)):
        best = (labels, inertia, centers, n_iter)
    labels, inertia, centers, n_iter = best
    self.cluster_centers_ = centers + mean
    self.labels_ = labels
    self.inertia_ = inertia
    self.n_iter_ = n_iter
    return self

  def fit_predict(self, X, y=None) -> torch.Tensor:
    return self.fit(X).labels_

  def predict(self, X) -> torch.Tensor:
    X = as_tensor(X, self.cluster_centers_.device, self.cluster_centers_.dtype)
    return self._labels(X, self.cluster_centers_)

  def transform(self, X) -> torch.Tensor:
    X = as_tensor(X, self.cluster_centers_.device, self.cluster_centers_.dtype)
    return torch.cat([torch.sqrt(sq_distances(X[rows],
                                              self.cluster_centers_))
                      for rows in row_chunks(X.shape[0], self.n_clusters,
                                             X.shape[1])]).to(X.dtype)


def _relocate_empty(X, centers_old, sums, weight, labels):
  """scikit-learn's ``_relocate_empty_clusters_dense``, in the data's
  dtype: the empty clusters, in order, take the rows farthest from their
  centres in the order ``np.argpartition`` gives them (on the host)."""
  empty = torch.nonzero(weight == 0).reshape(-1).tolist()
  if not empty:
    return sums, weight
  far = ((X - centers_old[labels]) ** 2).sum(1).cpu().numpy()
  if far.max() == 0:
    return sums, weight
  rows = np.argpartition(far, -len(empty))[:-len(empty) - 1:-1]
  sums, weight = sums.clone(), weight.clone()
  for new_id, row in zip(empty, rows.tolist()):
    old_id = int(labels[row])
    sums[old_id] -= X[row]
    sums[new_id] = X[row]
    weight[new_id] = 1.0
    weight[old_id] -= 1.0
  return sums, weight


def _average_centers(sums, weight):
  """scikit-learn's ``_average_centers``: each sum times the reciprocal of
  its weight, in the data's dtype; a cluster with no weight copies the
  heaviest cluster's row as it stands then (averaged if it came before)."""
  out = sums * (1.0 / torch.where(weight > 0, weight,
                                  torch.ones_like(weight)))[:, None]
  if bool((weight == 0).any()):
    heavy = int(torch.argmax(weight))
    for j in torch.nonzero(weight == 0).reshape(-1).tolist():
      out[j] = out[heavy] if heavy < j else sums[heavy]
  return out


def _same_clustering(a: torch.Tensor, b: torch.Tensor, k: int) -> bool:
  """scikit-learn's ``_is_same_clustering``: each label of `a` goes with
  one label of `b`."""
  return torch.unique(a * k + b).numel() == torch.unique(a).numel()


# ---------------------------------------------------------------------------
# scikit-learn's DBSCAN
# ---------------------------------------------------------------------------
class DBSCAN:
  """scikit-learn 1.9's ``DBSCAN(eps, min_samples)`` with the euclidean
  metric, on the device of X."""

  def __init__(self, eps: float = 0.5, *, min_samples: int = 5,
               metric: str = "euclidean", device=None, **kwargs):
    unknown = set(kwargs) - {"algorithm", "leaf_size", "n_jobs", "p",
                             "metric_params"}
    if unknown or metric != "euclidean" or kwargs.get("p") not in (None, 2):
      raise ValueError("only the euclidean DBSCAN is ported")
    self.eps = float(eps)
    self.min_samples = int(min_samples)
    self.metric = metric
    self.device = device

  def _edges(self, X: torch.Tensor):
    """(rows, cols) of every pair within eps, each pair both ways and each
    row with itself."""
    rows, cols = [], []
    r2 = self.eps * self.eps
    for chunk in row_chunks(X.shape[0], X.shape[0]):
      i, j = torch.nonzero(sq_distances(X[chunk], X) <= r2, as_tuple=True)
      rows.append(i + chunk.start)
      cols.append(j)
    return torch.cat(rows), torch.cat(cols)

  def fit(self, X, y=None) -> "DBSCAN":
    X = _float_tensor(X, self.device)
    n = X.shape[0]
    dev = X.device
    src, dst = self._edges(X)
    counts = torch.bincount(src, minlength=n)
    core = counts >= self.min_samples
    # the components of the core graph: min-label propagation, each round
    # followed by pointer jumping (comp[i] <= i always names a row of i's
    # component)
    cc = core[src] & core[dst]
    a, b = src[cc], dst[cc]
    comp = torch.arange(n, device=dev)
    while True:
      new = comp.clone().scatter_reduce_(0, b, comp[a], reduce="amin")
      while True:
        jumped = new[new]
        if torch.equal(jumped, new):
          break
        new = jumped
      if torch.equal(new, comp):
        break
      comp = new
    labels = torch.full((n,), -1, dtype=torch.int64, device=dev)
    roots, numbered = torch.unique(comp[core], return_inverse=True)
    labels[core] = numbered
    # a border row: the smallest cluster among its core neighbours
    border = core[src] & ~core[dst]
    big = torch.full((n,), n, dtype=torch.int64, device=dev)
    big.scatter_reduce_(0, dst[border], labels[src[border]], reduce="amin")
    take = ~core & (big < n)
    labels[take] = big[take]
    self.core_sample_indices_ = torch.nonzero(core).reshape(-1)
    self.components_ = X[self.core_sample_indices_].clone()
    self.labels_ = labels
    return self

  def fit_predict(self, X, y=None) -> torch.Tensor:
    return self.fit(X).labels_


# ---------------------------------------------------------------------------
# the JAX package's entry points
# ---------------------------------------------------------------------------
def fast_kmeans(X, *, n_clusters: int = 8, max_iter: int = 50,
                random_state: int = 1, framework: str = "jax", **kwargs):
  """k-means: the JAX package's Lloyd iteration (`framework` 'jax') or
  scikit-learn's ``KMeans`` with ``n_init=4`` (any other `framework`)."""
  if framework == "jax":
    return KMeansJax(n_clusters=n_clusters, n_iter=max_iter,
                     random_state=random_state,
                     device=kwargs.get("device")).fit(X)
  return KMeans(n_clusters=n_clusters, max_iter=max_iter,
                random_state=random_state, n_init=4, **kwargs).fit(X)


def fast_knn(X, y=None, *, n_neighbors: int = 5, **kwargs):
  """A fitted ``NearestNeighbors`` (no `y`) or ``KNeighborsClassifier``."""
  if y is None:
    return NearestNeighbors(n_neighbors=n_neighbors, **kwargs).fit(X)
  y = y.reshape(-1) if isinstance(y, torch.Tensor) else np.asarray(y).ravel()
  return KNeighborsClassifier(n_neighbors=n_neighbors, **kwargs).fit(X, y)


def fast_dbscan(X, *, eps: float = 0.5, min_samples: int = 5, **kwargs):
  """A fitted ``DBSCAN``."""
  return DBSCAN(eps=eps, min_samples=min_samples, **kwargs).fit(X)


def dbscan_predict(db, X=None) -> torch.Tensor:
  """Labels for a fitted ``DBSCAN``: its training labels without X; for new
  rows, the cluster of the nearest core sample within ``eps``, else noise
  (-1), as the JAX package assigns them."""
  if X is None:
    return db.labels_
  core = db.components_
  X = as_tensor(X, core.device)
  if core.shape[0] == 0:
    return torch.full((X.shape[0],), -1, dtype=torch.int64, device=core.device)
  core_labels = db.labels_[db.core_sample_indices_]
  out = []
  for rows in row_chunks(X.shape[0], core.shape[0], X.shape[1]):
    d2 = sq_distances(X[rows], core)
    nearest = torch.argmin(d2, dim=1)
    best = d2.gather(1, nearest[:, None])[:, 0]
    out.append(torch.where(sqrt_rn(best) <= db.eps, core_labels[nearest],
                           torch.full_like(nearest, -1)))
  return torch.cat(out)

