"""The port's ``LinearDiscriminantAnalysis`` (``odin_tpu_torch/ml/
discriminant.py``) against scikit-learn 1.9's, and ``VectorNormalizer(
lda=True)`` with the cosine ``Scorer`` against the JAX package's, on the
CPU.

Data: Gaussian classes around random centres (2 and 5 classes, uneven
counts, string labels), in float64 and float32.

Tolerances, of the reference's largest magnitude: float64 1e-9 (the same
two SVDs by LAPACK on both sides, measured near 1e-13); float32 1e-4 for
scores and probabilities (scikit-learn's own float32 SVDs lie about 1e-5
from float64 here).  ``transform`` is compared up to each column's sign:
the signs of ``scalings_`` come from the SVD, not a convention; the
coefficients, intercepts, decisions and probabilities do not depend on
them.
"""
import numpy as np
import pytest
import torch
from sklearn.discriminant_analysis import LinearDiscriminantAnalysis as SkLDA

from odin_tpu.ml import Scorer as JaxScorer
from odin_tpu.ml import VectorNormalizer as JaxVectorNormalizer
from odin_tpu_torch.ml import Scorer, VectorNormalizer
from odin_tpu_torch.ml.discriminant import LinearDiscriminantAnalysis
from odin_tpu_torch.weights import (from_jax_lda, from_jax_scorer,
                                    to_jax_lda, to_jax_scorer)

from torch_ml_common import close, up_to_sign

CPU = "cpu"
NAMES = np.array(["kim", "ada", "zed", "bo", "lee"])


def _data(n_classes, d=6, seed=0, dtype=np.float64):
  rng = np.random.RandomState(seed)
  counts = rng.randint(25, 45, n_classes)
  centres = rng.randn(n_classes, d) * 2
  X = np.concatenate([rng.randn(c, d) + centres[k]
                      for k, c in enumerate(counts)])
  y = np.repeat(NAMES[:n_classes], counts)
  order = rng.permutation(len(y))
  return X[order].astype(dtype), y[order]


@pytest.mark.parametrize("n_classes", [2, 5])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lda_matches_sklearn(n_classes, dtype):
  X, y = _data(n_classes, seed=n_classes, dtype=dtype)
  Xt, _ = _data(n_classes, seed=40 + n_classes, dtype=dtype)
  want = SkLDA().fit(X, y)
  got = LinearDiscriminantAnalysis(device=CPU).fit(X, y)
  tol = 1e-9 if dtype == np.float64 else 1e-4
  np.testing.assert_array_equal(got.classes_, want.classes_)
  assert got.coef_.dtype == torch.from_numpy(want.coef_).dtype
  close(got.coef_, want.coef_, tol, "coef_")
  close(got.intercept_, want.intercept_, tol, "intercept_")
  close(got.decision_function(Xt), want.decision_function(Xt), tol)
  close(got.predict_proba(Xt), want.predict_proba(Xt), tol)
  close(got.predict_log_proba(Xt), want.predict_log_proba(Xt), tol)
  np.testing.assert_array_equal(got.predict(Xt), want.predict(Xt))
  close(got.explained_variance_ratio_, want.explained_variance_ratio_, tol)
  Z = want.transform(Xt)
  assert tuple(got.transform(Xt).shape) == Z.shape
  close(up_to_sign(got.transform(Xt), Z, axis=0), Z, tol, "transform")
  assert got.score(X, y) == want.score(X, y)


def test_lda_options():
  X, y = _data(5, seed=9)
  for kw in (dict(n_components=2), dict(priors=[0.1, 0.2, 0.3, 0.2, 0.2]),
             dict(tol=1e-2)):
    want = SkLDA(**kw).fit(X, y)
    got = LinearDiscriminantAnalysis(device=CPU, **kw).fit(X, y)
    close(got.decision_function(X), want.decision_function(X), 1e-9)
    Z = want.transform(X)
    close(up_to_sign(got.transform(X), Z, axis=0), Z, 1e-9)
  with pytest.raises(ValueError):
    LinearDiscriminantAnalysis(n_components=9, device=CPU).fit(X, y)
  with pytest.raises(NotImplementedError):
    LinearDiscriminantAnalysis(solver="eigen")


def test_lda_bridge_round_trip():
  X, y = _data(5, seed=10)
  want = SkLDA().fit(X, y)
  got = from_jax_lda(want, CPU)
  close(got.transform(X), want.transform(X), 1e-12)
  close(got.predict_proba(X), want.predict_proba(X), 1e-12)
  mine = LinearDiscriminantAnalysis(device=CPU).fit(X, y)
  mirror = SkLDA()
  for k, v in to_jax_lda(mine).items():
    setattr(mirror, k, v)
  close(mirror.transform(X), mine.transform(X).numpy(), 1e-12)
  close(mirror.predict_proba(X), mine.predict_proba(X).numpy(), 1e-12)


def _jax_normalizer_with_lda(X, y, wccn):
  """What the JAX package's ``VectorNormalizer(lda=True).fit`` means to
  compute: scikit-learn's LDA fitted on the normaliser's own output, then
  applied after it.  JAX's own ``fit`` raises ``NotFittedError``: it sets
  the unfitted LDA before it calls its own ``transform`` (checked below),
  so its reference is built here from its normaliser and scikit-learn's
  LDA."""
  from sklearn.exceptions import NotFittedError
  with pytest.raises(NotFittedError):
    JaxVectorNormalizer(wccn=wccn, lda=True).fit(X, y)
  vn = JaxVectorNormalizer(wccn=wccn, lda=False).fit(X, y)
  lda = SkLDA().fit(vn.transform(X), y)
  vn.lda, vn.lda_model = True, lda
  return vn


@pytest.mark.parametrize("wccn", [False, True])
def test_vector_normalizer_with_lda_matches_jax(wccn):
  X, y = _data(5, d=10, seed=11)
  Xt, _ = _data(5, d=10, seed=12)
  want = _jax_normalizer_with_lda(X, y, wccn)
  got = VectorNormalizer(wccn=wccn, lda=True, device=CPU).fit(X, y)
  Z = want.transform(Xt)
  assert tuple(got.transform(Xt).shape) == Z.shape == (len(Xt), 4)
  close(up_to_sign(got.transform(Xt), Z, axis=0), Z, 1e-9)


def test_cosine_scorer_with_lda_matches_jax():
  """The LDA's column signs flip the test vectors and the enrolled means
  alike, so the cosine scores do not depend on them."""
  from odin_tpu.ml import scoring as jax_scoring
  X, y = _data(5, d=10, seed=13)
  Xt, _ = _data(5, d=10, seed=14)
  want = JaxScorer(wccn=True, lda=False).fit(X, y)
  want.normalizer = _jax_normalizer_with_lda(X, y, wccn=True)
  want.labels, want.enroll = jax_scoring.compute_class_avg(
      want.normalizer.transform(X), y)
  got = Scorer(wccn=True, lda=True, device=CPU).fit(X, y)
  np.testing.assert_array_equal(got.labels, want.labels)
  close(got.score(Xt), want.score(Xt), 1e-9, "cosine scores")
  close(got.predict_proba(Xt), want.predict_proba(Xt), 1e-9)
  np.testing.assert_array_equal(got.predict(Xt), want.predict(Xt))
  # through the bridge, JAX's fitted state gives JAX's scores
  close(from_jax_scorer(want, CPU).score(Xt), want.score(Xt), 1e-12)
  back = to_jax_scorer(got)
  assert back["normalizer"]["lda_model"]["_max_components"] == 4
  close(from_jax_scorer(back, CPU).score(Xt), got.score(Xt).numpy(), 1e-12)
