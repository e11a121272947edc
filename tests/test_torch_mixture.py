"""The port's ``GaussianMixture`` (``odin_tpu_torch/ml/mixture.py``)
against scikit-learn 1.9's from the same seed (the port's k-means replays
scikit-learn's draws, so both start from the same labels), and the GMM
embeddings (``ml/gmm_embedding.py``) against the JAX package's, on the
CPU.

Data: three Gaussian clusters in 3 dims (180 rows), 1-D bimodal scores,
and 4 classes of 6-dim vectors.

Tolerances, of the reference's largest magnitude: float64 1e-10 (the same
EM expression for expression; measured near 1e-14), with the same number of
EM iterations; float32 (float32 EM, scikit-learn's sums in another order),
2e-4 of scikit-learn's float64 fit, or twice scikit-learn's own float32
distance from it where that is larger (see
``test_gaussian_mixture_in_float32``). ``fit_batch`` equals each mixture
fitted alone. ``GMMThreshold`` within 1e-10; ``GMMclassifier`` and
``ProbabilisticEmbedding`` within 1e-9, predictions equal.
"""
import warnings

import numpy as np
import pytest
import torch
from sklearn.mixture import GaussianMixture as SkGM

from odin_tpu.ml import gmm_embedding as J
from odin_tpu_torch.ml import gmm_embedding as P
from odin_tpu_torch.ml.mixture import GaussianMixture
from odin_tpu_torch.weights import (from_jax_gaussian_mixture,
                                    from_jax_gmm_classifier,
                                    from_jax_gmm_threshold,
                                    from_jax_probabilistic_embedding,
                                    to_jax_gaussian_mixture,
                                    to_jax_gmm_classifier,
                                    to_jax_gmm_threshold,
                                    to_jax_probabilistic_embedding)

from torch_ml_common import close

CPU = "cpu"
TYPES = ("full", "tied", "diag", "spherical")


def _clusters(seed=0):
  rng = np.random.RandomState(seed)
  return np.concatenate([rng.randn(60, 3) + 3, rng.randn(70, 3) * 0.5 - 1,
                         rng.randn(50, 3) @ rng.randn(3, 3)])


def _np(t):
  return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


NAMES = ("weights_", "means_", "covariances_", "precisions_cholesky_",
         "precisions_")


def _sk(X, cov, **kw):
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")  # a capped fit warns it did not converge
    return SkGM(3, covariance_type=cov, random_state=1, **kw).fit(X)


@pytest.mark.parametrize("cov", TYPES)
def test_gaussian_mixture_matches_sklearn(cov):
  X, Xt = _clusters(1), _clusters(2)
  want = _sk(X, cov)
  got = GaussianMixture(3, covariance_type=cov, random_state=1,
                        device=CPU).fit(X)
  tol = 1e-10
  assert got.n_iter_ == want.n_iter_
  assert got.converged_ == want.converged_
  for name in NAMES:
    close(getattr(got, name), getattr(want, name), tol, name)
  close(got.score_samples(Xt), want.score_samples(Xt), tol)
  close(got.predict_proba(Xt), want.predict_proba(Xt), tol)
  np.testing.assert_array_equal(_np(got.predict(Xt)), want.predict(Xt))
  assert abs(got.score(Xt) - want.score(Xt)) <= tol * abs(want.score(Xt))
  assert abs(got.bic(Xt) - want.bic(Xt)) <= tol * abs(want.bic(Xt))
  assert abs(got.aic(Xt) - want.aic(Xt)) <= tol * abs(want.aic(Xt))
  assert abs(got.lower_bound_ - want.lower_bound_) <= tol * abs(
      want.lower_bound_)


@pytest.mark.parametrize("cov", TYPES)
def test_gaussian_mixture_in_float32(cov):
  """A float32 fit stays float32.  Its EM may stop one step apart from
  scikit-learn's (the change of the mean log-likelihood at the limit's
  rounding), and the third cluster's skewed covariance makes the full
  fit's float32 rounding grow: scikit-learn's own float32 parameters lie
  up to 2e-1 of the largest from its float64 ones there.  So both float32
  fits are held to scikit-learn's float64 fit at the port's step count:
  the port within 2e-4 (its weights measured 1.2e-4 from float64 for the
  full covariances, scikit-learn's 6.1e-5), or within twice
  scikit-learn's own distance where that is larger."""
  X = _clusters(1).astype(np.float32)
  got = GaussianMixture(3, covariance_type=cov, random_state=1,
                        device=CPU).fit(X)
  assert got.means_.dtype == torch.float32
  want32 = _sk(X, cov)
  assert abs(got.n_iter_ - want32.n_iter_) <= 1
  want32 = _sk(X, cov, max_iter=got.n_iter_, tol=0)
  want64 = _sk(X.astype(np.float64), cov, max_iter=got.n_iter_, tol=0)
  for name in NAMES:
    ref = getattr(want64, name)
    scale = np.abs(ref).max()
    own = np.abs(getattr(want32, name) - ref).max() / scale
    apart = np.abs(_np(getattr(got, name)) - ref).max() / scale
    assert apart <= max(2e-4, 2 * own), (name, apart, own)


@pytest.mark.parametrize("cov", TYPES)
def test_gaussian_mixture_options_and_bridge(cov):
  X = _clusters(3)
  kw = dict(reg_covar=1e-2, tol=1e-5, max_iter=7)
  want = SkGM(2, covariance_type=cov, random_state=4, **kw).fit(X)
  got = GaussianMixture(2, covariance_type=cov, random_state=4, device=CPU,
                        **kw).fit(X)
  assert got.n_iter_ == want.n_iter_
  close(got.means_, want.means_, 1e-10)
  mirror = from_jax_gaussian_mixture(want, CPU)
  close(mirror.score_samples(X), want.score_samples(X), 1e-12)
  back = SkGM(2, covariance_type=cov)
  for k, v in to_jax_gaussian_mixture(got).items():
    setattr(back, k, v)
  close(back.score_samples(X), _np(got.score_samples(X)), 1e-12)


def test_gaussian_mixture_from_given_parameters():
  X = _clusters(5)
  init = dict(weights_init=[0.3, 0.7], means_init=[[0, 0, 0], [3, 3, 3]],
              precisions_init=[[1, 1, 1], [2, 2, 2]])
  want = SkGM(2, covariance_type="diag", **init).fit(X)
  got = GaussianMixture(2, covariance_type="diag", device=CPU,
                        **init).fit(X)
  close(got.means_, want.means_, 1e-10)


def test_fit_batch_equals_each_fit():
  X = _clusters(6)
  cols = np.stack([X[:, i:i + 1] for i in range(3)])
  batch = GaussianMixture(2, covariance_type="diag", random_state=1,
                          device=CPU).fit_batch(cols)
  for i in range(3):
    want = SkGM(2, covariance_type="diag", random_state=1).fit(cols[i])
    assert int(batch.n_iter_[i]) == want.n_iter_
    close(batch.means_[i], want.means_, 1e-10)
    close(batch.covariances_[i], want.covariances_, 1e-10)
  assert tuple(batch.score_samples(cols).shape) == (3, len(X))


def _bimodal(seed=7, n=400):
  rng = np.random.RandomState(seed)
  return np.concatenate([rng.randn(n // 2) * 0.5 - 1.5,
                         rng.randn(n - n // 2) * 0.8 + 2.0])


def test_gmm_threshold_matches_jax():
  x = _bimodal()
  want = J.GMMThreshold().fit(x)
  got = P.GMMThreshold(device=CPU).fit(x)
  assert abs(got.threshold_ - want.threshold_) <= 1e-10
  assert -1.5 < got.threshold_ < 2.0
  np.testing.assert_array_equal(_np(got.predict(x)), want.predict(x))
  th = from_jax_gmm_threshold(want, CPU)
  assert th.threshold_ == want.threshold_
  assert to_jax_gmm_threshold(got)["threshold_"] == got.threshold_
  np.testing.assert_array_equal(_np(th.predict(x)), want.predict(x))


def _scores(seed=8, n=300, d=4):
  rng = np.random.RandomState(seed)
  y = rng.randint(0, 2, (n, d))
  return np.clip(y * 0.7 + rng.rand(n, d) * 0.4 + rng.randn(n, d) * 0.05,
                 0, 1.2)


def test_probabilistic_embedding_matches_jax(tmp_path):
  X = _scores()
  want = J.ProbabilisticEmbedding().fit(X)
  got = P.ProbabilisticEmbedding(device=CPU).fit(X)
  close(got.predict_proba(X), want.predict_proba(X), 1e-9)
  np.testing.assert_array_equal(_np(got.binarize(X)), want.binarize(X))
  close(got.fit_transform(X), want.fit_transform(X), 1e-9)
  close(from_jax_probabilistic_embedding(want, CPU).predict_proba(X),
        want.predict_proba(X), 1e-12)
  back = from_jax_probabilistic_embedding(
      to_jax_probabilistic_embedding(got), CPU)
  close(back.predict_proba(X), _np(got.predict_proba(X)), 1e-12)
  got.plot_diagnosis(X).plot_distribution(X).boxplot(X)
  path = got.save_figures(str(tmp_path / "pe.pdf"))
  assert (tmp_path / "pe.pdf").stat().st_size > 1000 and path


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_gmm_classifier_matches_jax(cov):
  rng = np.random.RandomState(9)
  counts = [40, 40, 25, 7]  # equal counts share a batch; 7 // 2 = 3 rows
  centres = rng.randn(4, 6) * 3
  X = np.concatenate([rng.randn(c, 6) + centres[k]
                      for k, c in enumerate(counts)])
  y = np.repeat(np.array(["d", "a", "c", "b"]), counts)
  Xt = np.concatenate([rng.randn(10, 6) + centres[k] for k in range(4)])
  want = J.GMMclassifier(n_components=3, covariance_type=cov).fit(X, y)
  got = P.GMMclassifier(n_components=3, covariance_type=cov,
                        device=CPU).fit(X, y)
  assert [g.n_components for g in got._gmms] == \
      [g.n_components for g in want._gmms]
  close(got.decision_function(Xt), want.decision_function(Xt), 1e-9)
  close(got.predict_proba(Xt), want.predict_proba(Xt), 1e-9)
  np.testing.assert_array_equal(got.predict(Xt), want.predict(Xt))
  assert got.labels == want.labels
  mirror = from_jax_gmm_classifier(want, CPU)
  close(mirror.decision_function(Xt), want.decision_function(Xt), 1e-12)
  back = from_jax_gmm_classifier(to_jax_gmm_classifier(got), CPU)
  close(back.predict_proba(Xt), _np(got.predict_proba(Xt)), 1e-12)
