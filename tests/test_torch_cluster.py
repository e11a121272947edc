"""The port's clustering (``odin_tpu_torch/ml/cluster.py``,
``neighbors.py``, ``naive_bayes.py``) against the JAX package's
``odin_tpu/ml/cluster.py`` and against the scikit-learn calls it makes, on
the CPU, with numpy inputs drawn from a seed: 1,500 rows of 6 latents that
are noisy mixes of five dSprites-like factors (3, 6, 40, 32 and 32 values),
a one-feature column of integers (many exact ties), and Gaussian blobs
with noise (DBSCAN's clusters, cores and border rows).

Limits, as measured:
- exact: ``KMeansJax``'s seeding indices, labels, iteration count and
  ``predict`` against the JAX package's (4, 16 and 64 clusters).  Each
  seeding draw searches the cumulative sum of p = d²/Σd²; the port sums d²
  in float64 and rounds it, where numpy sums float32 pairwise, which moves
  p by about one float32 ulp, so a draw can only change where the uniform
  lands within that of a boundary.  The port's Lloyd distances are float64
  where JAX's are float32, so a row within float32 rounding of a tie could
  take the other centre (at 4 clusters row 1151 lies within 7e-7, relative,
  of one at step 28; JAX's float32 rounding picks the nearer centre there,
  as float64 does).  At these sizes neither happened.  The centres are held
  within 1e-6 (float32 means summed in another order), ``transform``
  within 1e-6;
- exact: scikit-learn's ``KMeans`` labels and ``n_iter_`` (k-means++ with
  ``n_init`` 1 and 4, an array init, and the integer column whose ties
  scikit-learn's float32 rounding decides; 0 rows differed), its inertia
  within rtol 1e-4 (scikit-learn sums it in float32, in an order set by
  its OpenMP thread count: 3.6e-6 apart between one thread and two,
  measured) and its centres within 1e-5;
- exact: ``NearestNeighbors.kneighbors`` (with and without a query; the
  distances within 1e-12), ``KNeighborsClassifier``'s predictions and
  probabilities (vote ties to the smallest class), the DBSCAN labels,
  ``core_sample_indices_``, ``components_`` and ``dbscan_predict``, and the
  naive-Bayes predictions (their log-probabilities within 1e-10).
"""
import numpy as np
import pytest
import torch

import jax
from odin_tpu.ml import cluster as jcl
from sklearn.cluster import DBSCAN as SkDBSCAN
from sklearn.cluster import KMeans as SkKMeans
from sklearn.neighbors import KNeighborsClassifier as SkKNN
from sklearn.neighbors import NearestNeighbors as SkNN

from odin_tpu_torch import ml as pml
from odin_tpu_torch.ml import cluster as pcl

torch.set_num_threads(2)
SIZES = (3, 6, 40, 32, 32)


def latents_and_factors(n=1500, d=6, seed=0):
  rng = np.random.RandomState(seed)
  f = np.stack([rng.randint(0, k, n) for k in SIZES], 1)
  u = f / (np.array(SIZES) - 1.0)
  mix = rng.rand(len(SIZES), d) * (rng.rand(len(SIZES), d) < 0.4)
  mix[np.arange(d) % len(SIZES), np.arange(d)] += 1.0
  z = u @ mix + 0.3 * rng.randn(n, d)
  return z.astype(np.float32), f


def blobs(n=600, seed=1):
  """Four Gaussian blobs of 3 features and uniform noise (float32)."""
  rng = np.random.RandomState(seed)
  centres = rng.uniform(-6, 6, (4, 3))
  x = np.concatenate([c + 0.5 * rng.randn(n // 5, 3) for c in centres] +
                     [rng.uniform(-8, 8, (n - 4 * (n // 5), 3))])
  return x.astype(np.float32)


@pytest.fixture
def jax_step_counter(monkeypatch):
  """Counts the JAX package's k-means steps: each call of the jitted
  ``step`` that ``KMeansJax.fit`` builds."""
  calls = []
  jit = jax.jit

  def counting_jit(fn, *args, **kwargs):
    jitted = jit(fn, *args, **kwargs)

    if getattr(fn, "__name__", "") != "step":
      return jitted

    def run(*a, **k):
      calls.append(1)
      return jitted(*a, **k)
    return run

  monkeypatch.setattr(jcl.jax, "jit", counting_jit)
  return calls


@pytest.mark.parametrize("k", [4, 16, 64])
def test_kmeans_jax_matches_jax(k, jax_step_counter):
  z, _ = latents_and_factors()
  want_seeds = jcl.KMeansJax(n_clusters=k)._init_centers(
      z, np.random.RandomState(1))
  want = jcl.KMeansJax(n_clusters=k, n_iter=50).fit(z)
  got = pcl.KMeansJax(n_clusters=k, n_iter=50).fit(torch.tensor(z))
  seeds = got.seed_indices_.numpy()
  np.testing.assert_array_equal(z[seeds], want_seeds)
  np.testing.assert_array_equal(got.labels_.numpy(), want.labels_)
  assert got.n_iter_ == len(jax_step_counter)
  np.testing.assert_allclose(got.cluster_centers_.numpy(),
                             want.cluster_centers_, rtol=0, atol=1e-6)
  np.testing.assert_array_equal(got.predict(torch.tensor(z[:400])).numpy(),
                                want.predict(z[:400]))
  np.testing.assert_allclose(got.transform(torch.tensor(z[:50])).numpy(),
                             want.transform(z[:50]), rtol=0, atol=1e-6)
  np.testing.assert_array_equal(got.fit_predict(torch.tensor(z)).numpy(),
                                want.labels_)


def _assert_kmeans_equal(got, want):
  np.testing.assert_array_equal(got.labels_.numpy(), want.labels_)
  assert got.n_iter_ == want.n_iter_
  # scikit-learn sums the inertia in float32 over its OpenMP threads, so
  # its own value moves with the thread count (3.6e-6 between one and two)
  assert got.inertia_ == pytest.approx(want.inertia_, rel=1e-4)
  np.testing.assert_allclose(got.cluster_centers_.numpy(),
                             want.cluster_centers_, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k,n_init", [(3, 1), (6, 4), (40, 4)])
def test_sklearn_kmeans_matches(k, n_init):
  z, _ = latents_and_factors()
  want = SkKMeans(n_clusters=k, n_init=n_init, random_state=1).fit(z)
  got = pcl.KMeans(n_clusters=k, n_init=n_init, random_state=1).fit(
      torch.tensor(z))
  _assert_kmeans_equal(got, want)
  np.testing.assert_array_equal(got.predict(torch.tensor(z[:300])).numpy(),
                                want.predict(z[:300]))


@pytest.mark.parametrize("n_bins", [5, 8])
def test_sklearn_kmeans_ties_and_array_init(n_bins):
  """Integer-valued data (every distance to a centre tied in groups) from
  the uniform bins' centres, as KBinsDiscretizer starts it, and k-means++
  on the same column."""
  rng = np.random.RandomState(2)
  col = np.round(rng.randn(900) * 2).astype(np.float32)[:, None]
  edges = np.linspace(col.min(), col.max(), n_bins + 1)
  init = (edges[1:] + edges[:-1])[:, None] * 0.5
  _assert_kmeans_equal(
      pcl.KMeans(n_clusters=n_bins, init=init, n_init=1).fit(
          torch.tensor(col)),
      SkKMeans(n_clusters=n_bins, init=init, n_init=1).fit(col))
  _assert_kmeans_equal(
      pcl.KMeans(n_clusters=n_bins, n_init=1, random_state=3).fit(
          torch.tensor(col)),
      SkKMeans(n_clusters=n_bins, n_init=1, random_state=3).fit(col))


@pytest.mark.parametrize("framework", ["jax", "sklearn"])
def test_fast_kmeans_and_clustering_match_jax(framework):
  z, _ = latents_and_factors(n=800)
  want = jcl.fast_kmeans(z, n_clusters=12, framework=framework)
  got = pml.fast_kmeans(torch.tensor(z), n_clusters=12, framework=framework)
  np.testing.assert_array_equal(got.labels_.numpy(), want.labels_)
  again = pml.clustering(torch.tensor(z), "kmeans", n_clusters=12,
                         framework=framework)
  np.testing.assert_array_equal(again.labels_.numpy(), want.labels_)


def test_nearest_neighbors_match_sklearn():
  z, _ = latents_and_factors(n=700)
  want = SkNN(n_neighbors=7).fit(z)
  got = pml.fast_knn(torch.tensor(z), n_neighbors=7)
  for query in (None, z[:90]):
    wd, wi = want.kneighbors(query)
    gd, gi = got.kneighbors(None if query is None else torch.tensor(query))
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_allclose(gd.numpy(), wd, rtol=0, atol=1e-12)
  gi = pml.clustering(torch.tensor(z), "knn", n_clusters=7).kneighbors(
      return_distance=False)
  np.testing.assert_array_equal(gi.numpy(), want.kneighbors()[1])


@pytest.mark.parametrize("k", [4, 5])  # 4: vote ties, to the smallest class
def test_knn_classifier_matches_jax(k):
  z, f = latents_and_factors(n=1000)
  want = jcl.fast_knn(z[:800], f[:800, 1], n_neighbors=k)
  got = pml.fast_knn(torch.tensor(z[:800]), torch.tensor(f[:800, 1]),
                     n_neighbors=k)
  assert isinstance(want, SkKNN)
  np.testing.assert_array_equal(got.predict(torch.tensor(z[800:])).numpy(),
                                want.predict(z[800:]))
  np.testing.assert_array_equal(
      got.predict_proba(torch.tensor(z[800:])).numpy(),
      want.predict_proba(z[800:]))
  assert got.score(torch.tensor(z[800:]), torch.tensor(f[800:, 1])) == \
      want.score(z[800:], f[800:, 1])


@pytest.mark.parametrize("eps,min_samples", [(0.6, 5), (0.9, 10), (0.3, 4)])
def test_dbscan_matches_jax(eps, min_samples):
  x = blobs()
  want = jcl.fast_dbscan(x[:500], eps=eps, min_samples=min_samples)
  got = pml.fast_dbscan(torch.tensor(x[:500]), eps=eps,
                        min_samples=min_samples)
  assert isinstance(want, SkDBSCAN)
  np.testing.assert_array_equal(got.labels_.numpy(), want.labels_)
  np.testing.assert_array_equal(got.core_sample_indices_.numpy(),
                                want.core_sample_indices_)
  np.testing.assert_array_equal(got.components_.numpy(), want.components_)
  np.testing.assert_array_equal(pcl.dbscan_predict(got).numpy(),
                                jcl.dbscan_predict(want))
  np.testing.assert_array_equal(
      pcl.dbscan_predict(got, torch.tensor(x[500:])).numpy(),
      jcl.dbscan_predict(want, x[500:]))
  again = pml.clustering(torch.tensor(x[:500]), "dbscan", eps=eps,
                         min_samples=min_samples)
  np.testing.assert_array_equal(again.labels_.numpy(), want.labels_)


def test_dbscan_border_rows_take_the_first_cluster():
  """Two dense groups joined through one border row within eps of a core
  of each: the row takes the lower-numbered cluster."""
  x = np.array([[0.0], [0.1], [0.2], [1.0], [1.8], [1.9], [2.0]],
               np.float32)
  want = SkDBSCAN(eps=0.85, min_samples=3).fit(x)
  got = pcl.DBSCAN(eps=0.85, min_samples=3).fit(torch.tensor(x))
  np.testing.assert_array_equal(got.labels_.numpy(), want.labels_)
  np.testing.assert_array_equal(got.core_sample_indices_.numpy(),
                                want.core_sample_indices_)


@pytest.mark.parametrize("distribution", ["categorical", "multinomial",
                                          "bernoulli"])
@pytest.mark.parametrize("prior", ["fit", "uniform", "given"])
def test_naive_bayes_matches_jax(distribution, prior):
  z, f = latents_and_factors(n=1000)
  lo, hi = z.min(0), z.max(0)
  x = np.clip(((z - lo) / (hi - lo) * 10).astype(np.int64), 0, 9)
  x[:, 0] -= 1  # bernoulli's binarisation at 0 then splits a column
  x = np.clip(x, 0, None)
  y = f[:, 1]
  kw = dict(fit_prior=prior != "uniform",
            class_prior=np.arange(1, 7) / 21.0 if prior == "given" else None,
            alpha=0.5)
  want = jcl.fast_naive_bayes(x[:800], y[:800], distribution, **kw)
  got = pml.fast_naive_bayes(torch.tensor(x[:800]), torch.tensor(y[:800]),
                             distribution, **kw)
  test = torch.tensor(x[800:])
  np.testing.assert_array_equal(got.predict(test).numpy(),
                                want.predict(x[800:]))
  np.testing.assert_allclose(got.predict_log_proba(test).numpy(),
                             want.predict_log_proba(x[800:]), rtol=0,
                             atol=1e-10)
  np.testing.assert_allclose(got.class_log_prior_.numpy(),
                             want.class_log_prior_, rtol=0, atol=1e-12)


def test_entry_points_raise_on_bad_input():
  z, _ = latents_and_factors(n=50)
  with pytest.raises(ValueError, match="n_clusters"):
    pcl.KMeans(n_clusters=60).fit(torch.tensor(z))
  with pytest.raises(ValueError, match="NB distribution"):
    pml.fast_naive_bayes(torch.tensor(z), torch.zeros(50), "gaussian")
  with pytest.raises(ValueError, match="no clustering algorithm"):
    pml.clustering(torch.tensor(z), "spectral")
