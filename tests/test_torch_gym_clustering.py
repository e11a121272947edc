"""The port's clustering scores, k-NN mutual information, Lasso and
discretizers (``odin_tpu_torch/bay/vi/{cluster_scores,
correlation_estimators,discretizers,metrics,utils}.py``) against the JAX
package's functions and the scikit-learn calls they make, on the CPU, on the
same numpy inputs drawn from a seed: 1,500 rows of 6 latents that are noisy
mixes of five dSprites-like factors (3, 6, 40, 32 and 32 values), or the
first 400-800 of them where a test runs many estimates.

Limits, as measured:
- ARI, AMI and NMI to 1e-12 (measured: up to 4e-14; AMI's expected mutual
  information sums lgamma terms in another order);
- silhouette to 1e-6 (measured: up to 1.2e-8; scikit-learn keeps float32
  per-cluster sums, the port rounds its float64 sums to them);
- ``unsupervised_clustering_scores``: scikit-learn's KMeans labels equal
  (0 rows differed), then the scores at the limits above;
- the k-NN mutual information to 1e-6 (measured: up to 9e-16; no distance
  tie at these sizes);
- Lasso's coefficients within 1e-6 of the largest (measured: 3.7e-8; the
  port's float64 Gram-matrix sweeps against scikit-learn's float32
  residual updates) with the same iteration count;
- the quantile and kmeans bins equal, the quantile edges equal and the
  kmeans edges within 1e-6 of the column's largest magnitude (measured:
  up to 4.5e-8, a float32 ulp or two: the centres' means summed in another
  order), the gmm bins on all but 0.5 % of the rows (measured: all
  equal).  One exception, measured: for the kmeans
  strategy on a column with fewer distinct values than bins, two centres
  start on one value, and whether its rows take the first or the second
  is decided by the last float32 bit of scikit-learn's per-cluster sums,
  whose order depends on its OpenMP thread count.  There the bins are held
  to the same partition of the rows, in the same order of values.
"""
import warnings

import numpy as np
import pytest
import torch

from odin_tpu.bay.vi import metrics as jm
from odin_tpu.bay.vi import utils as jutils
from sklearn import metrics as skm
from sklearn.feature_selection import mutual_info_classif as sk_mic
from sklearn.feature_selection import mutual_info_regression as sk_mir
from sklearn.linear_model import Lasso as SkLasso
from sklearn.mixture import GaussianMixture as SkGMM
from sklearn.preprocessing import KBinsDiscretizer

from odin_tpu_torch.bay.vi import cluster_scores as cs
from odin_tpu_torch.bay.vi import correlation_estimators as ce
from odin_tpu_torch.bay.vi import metrics as pm
from odin_tpu_torch.bay.vi import utils as putils

torch.set_num_threads(2)
warnings.filterwarnings("ignore", module="sklearn")
SIZES = (3, 6, 40, 32, 32)


def latents_and_factors(n=1500, d=6, seed=0):
  rng = np.random.RandomState(seed)
  f = np.stack([rng.randint(0, k, n) for k in SIZES], 1)
  u = f / (np.array(SIZES) - 1.0)
  mix = rng.rand(len(SIZES), d) * (rng.rand(len(SIZES), d) < 0.4)
  mix[np.arange(d) % len(SIZES), np.arange(d)] += 1.0
  z = u @ mix + 0.3 * rng.randn(n, d)
  return z.astype(np.float32), f


def label_pairs():
  rng = np.random.RandomState(5)
  a = rng.randint(0, 7, 400)
  noisy = np.where(rng.rand(400) < 0.3, rng.randint(0, 9, 400), a)
  return [(a, noisy), (a, a), (a, np.zeros(400, int)),
          (np.zeros(400, int), np.zeros(400, int)),
          (rng.randint(0, 40, 1500), rng.randint(0, 3, 1500)),
          (np.repeat([5, -2, 9], 3), np.array([1, 1, 1, 2, 2, 3, 3, 3, 3]))]


@pytest.mark.parametrize("name", ["adjusted_rand_score",
                                  "adjusted_mutual_info_score",
                                  "normalized_mutual_info_score"])
def test_label_scores_match_sklearn(name):
  for a, b in label_pairs():
    want = getattr(skm, name)(a, b)
    got = getattr(cs, name)(torch.tensor(a), torch.tensor(b))
    assert got == pytest.approx(want, rel=0, abs=1e-12), (name, a[:5], b[:5])


@pytest.mark.parametrize("j", range(5))
def test_silhouette_matches_sklearn(j):
  z, f = latents_and_factors()
  want = skm.silhouette_score(z, f[:, j])
  assert cs.silhouette_score(torch.tensor(z), torch.tensor(f[:, j])) == \
      pytest.approx(want, abs=1e-6)


def test_silhouette_raises_where_sklearn_does():
  z, _ = latents_and_factors(n=40)
  for labels in (np.zeros(40, int), np.arange(40)):
    with pytest.raises(ValueError, match="Number of labels"):
      skm.silhouette_score(z, labels)
    with pytest.raises(ValueError, match="Number of labels"):
      cs.silhouette_score(torch.tensor(z), torch.tensor(labels))


@pytest.mark.parametrize("j", range(5))
def test_unsupervised_clustering_scores_match_jax(j):
  z, f = latents_and_factors()
  want = jm.unsupervised_clustering_scores(f[:, j], z, random_state=1)
  got = pm.unsupervised_clustering_scores(torch.tensor(f[:, j]),
                                          torch.tensor(z), random_state=1)
  assert set(got) == set(want)
  for key in ("ari", "ami", "nmi"):
    assert got[key] == pytest.approx(want[key], abs=1e-12), key
  assert got["asw"] == pytest.approx(want["asw"], abs=1e-6)
  given = pm.unsupervised_clustering_scores(
      torch.tensor(f[:, j]), predictions=torch.tensor(f[:, (j + 1) % 5]))
  assert given == pytest.approx(jm.unsupervised_clustering_scores(
      f[:, j], predictions=f[:, (j + 1) % 5]), abs=1e-12)


@pytest.mark.parametrize("n_neighbors", [3, 5])
def test_knn_mutual_information_matches_sklearn(n_neighbors):
  z, f = latents_and_factors(n=800)
  for j in range(5):
    want = sk_mic(z, f[:, j], n_neighbors=n_neighbors, random_state=1)
    got = ce.mutual_info_classif(torch.tensor(z), torch.tensor(f[:, j]),
                                 n_neighbors=n_neighbors, random_state=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
  y = z[:, 0] * 2 + f[:, 1]
  want = sk_mir(z[:600], y[:600], n_neighbors=n_neighbors, random_state=1)
  got = ce.mutual_info_regression(torch.tensor(z[:600]),
                                  torch.tensor(y[:600]),
                                  n_neighbors=n_neighbors, random_state=1)
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("continuous_factors", [False, True])
def test_mutual_info_estimate_matches_jax(continuous_factors):
  z, f = latents_and_factors(n=400)
  f = f.astype(np.float32)
  if continuous_factors:
    f = f + np.random.RandomState(3).rand(*f.shape).astype(np.float32)
  want = jm.mutual_info_estimate(z, f, continuous_factors=continuous_factors)
  got = pm.mutual_info_estimate(torch.tensor(z), torch.tensor(f),
                                continuous_factors=continuous_factors)
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
  codes = jutils.discretizing(z, n_bins=8)
  want = jm.mutual_info_estimate(codes, f.astype(np.int64),
                                 continuous_latents=False)
  got = pm.mutual_info_estimate(torch.tensor(codes),
                                torch.tensor(f.astype(np.int64)),
                                continuous_latents=False)
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("alpha", [0.05, 0.5])
def test_lasso_matches_sklearn(alpha):
  z, f = latents_and_factors()
  want = SkLasso(alpha=alpha, random_state=1).fit(z, f.astype(np.float32))
  got = ce.Lasso(alpha=alpha, random_state=1).fit(torch.tensor(z),
                                                  torch.tensor(f))
  scale = np.abs(want.coef_).max()
  np.testing.assert_allclose(got.coef_.numpy(), want.coef_, rtol=0,
                             atol=1e-6 * scale)
  assert got.n_iter_ == want.n_iter_
  np.testing.assert_allclose(got.intercept_.numpy(), want.intercept_,
                             rtol=1e-5, atol=1e-5 * scale)
  one = ce.Lasso(alpha=alpha).fit(torch.tensor(z), torch.tensor(f[:, 2]))
  np.testing.assert_allclose(one.coef_.numpy(), want.coef_[2], rtol=0,
                             atol=1e-6 * scale)


@pytest.mark.parametrize("method", ["lasso", "mutualinfo"])
def test_correlation_matrix_matches_jax(method):
  z, f = latents_and_factors(n=500)
  want = jm.correlation_matrix(z, f, method=method)
  got = pm.correlation_matrix(torch.tensor(z), torch.tensor(f),
                              method=method)
  atol = 1e-6 * np.abs(want).max()
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
  assert pm.relative_strength(got) == pytest.approx(
      jm.relative_strength(want), abs=1e-6)


@pytest.mark.parametrize("strategy", ["quantile", "kmeans", "gmm"])
@pytest.mark.parametrize("n_bins", [5, 10])
def test_discretizing_strategies_match_jax(strategy, n_bins):
  z, f = latents_and_factors(n=1200)
  # a column whose quantiles repeat (narrow bins removed) and a constant
  z = np.concatenate([z, np.round(z[:, :1]) ** 2,
                      np.full((len(z), 1), 3.0, np.float32)], 1)
  if strategy == "gmm":
    z = z[:, :-1]  # a mixture needs as many distinct values as components
  want, models = jutils.discretizing(z, n_bins=n_bins, strategy=strategy,
                                     return_model=True)
  got, got_models = putils.discretizing(torch.tensor(z), n_bins=n_bins,
                                        strategy=strategy, return_model=True)
  if strategy == "gmm":
    assert (got.numpy() != want).mean() <= 0.005
    for got_m, sk in zip(got_models, models):
      np.testing.assert_allclose(got_m["means"].numpy(), sk.means_.ravel(),
                                 rtol=1e-4, atol=1e-5)
    return
  got = got.numpy()
  tied = [6] if strategy == "kmeans" else []
  exact = [j for j in range(z.shape[1]) if j not in tied]
  np.testing.assert_array_equal(got[:, exact], want[:, exact])
  for j in exact:
    # kmeans edges are float32 means summed in another order
    atol = 1e-6 * np.abs(z[:, j]).max() if strategy == "kmeans" else 0.0
    np.testing.assert_allclose(got_models[j], models[0].bin_edges_[j],
                               rtol=0, atol=atol)
  for j in tied:  # the same partition of the rows, in the order of values
    values = np.unique(z[:, j])
    first = [np.flatnonzero(z[:, j] == v)[0] for v in values]
    for bins in (got[:, j], want[:, j]):
      assert np.all(np.diff(bins[first]) > 0)
      assert all(len(np.unique(bins[z[:, j] == v])) == 1 for v in values)


def test_discretizing_gmm_matches_sklearn_mixture():
  z, _ = latents_and_factors(n=900)
  col = z[:, 3:4]
  sk = SkGMM(n_components=6, random_state=1).fit(col)
  got = putils.discretizing(torch.tensor(col), n_bins=6, strategy="gmm",
                            return_model=True)[1][0]
  order = np.argsort(sk.means_.ravel())
  np.testing.assert_allclose(np.sort(got["means"].numpy()),
                             sk.means_.ravel()[order], rtol=1e-4, atol=1e-5)
  np.testing.assert_allclose(got["weights"].numpy()[np.argsort(
      got["means"].numpy())], sk.weights_[order], rtol=1e-4, atol=1e-5)


def test_kbins_quantile_edges_match_sklearn():
  rng = np.random.RandomState(4)
  for n in (9, 101, 1000):
    x = rng.randn(n, 2).astype(np.float32)
    est = KBinsDiscretizer(n_bins=7, encode="ordinal", strategy="quantile")
    want = est.fit_transform(x)
    got, edges = putils.discretizing(torch.tensor(x), n_bins=7,
                                     strategy="quantile", return_model=True)
    np.testing.assert_array_equal(got.numpy(), want)
    for j in range(2):
      np.testing.assert_array_equal(edges[j], est.bin_edges_[j])


def test_discretizing_rejects_an_unknown_strategy():
  with pytest.raises(ValueError, match="strategy"):
    putils.discretizing(torch.zeros(4, 2), strategy="median")
