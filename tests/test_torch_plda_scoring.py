"""The port's scoring and PLDA (``odin_tpu_torch/ml/scoring.py``,
``odin_tpu_torch/ml/plda.py``) against the JAX package's on the CPU.

Data: tests/test_ml.py's PLDA layout (10 classes around centres 3·N(0, I)
in 20 dims, unit noise), with uneven class counts (18-22, so that PLDA's
grouping by count has several groups) and string labels in no order.

Tolerances: both packages compute in float64, the port with torch's
kernels and JAX's with numpy's, so results differ by rounding carried
through the inversions: 1e-10 of the largest magnitude for the
normaliser, the class means and covariances, the cosine scores and PLDA's
params; 1e-8 for PLDA's llrs, whose Schur-complement form inverts
tot - B tot⁻¹ B (measured 8e-11 of 116 against JAX, 1.3e-10 against the
port's own ``score_trials``); predictions equal.  PCA
initialisation: ``Phi`` up to each column's sign, the port taking
scikit-learn's convention (the largest entry of each component positive).
"""
import numpy as np
import pytest
import torch

from odin_tpu.ml import PLDA as JaxPLDA
from odin_tpu.ml import Scorer as JaxScorer
from odin_tpu.ml import VectorNormalizer as JaxVectorNormalizer
from odin_tpu.ml import scoring as jax_scoring
from odin_tpu_torch.ml import (PLDA, Scorer, VectorNormalizer,
                               compute_class_avg, compute_wccn,
                               compute_within_cov)
from odin_tpu_torch.weights import (from_jax_plda, from_jax_scorer,
                                    to_jax_plda, to_jax_scorer)

from torch_ml_common import close, up_to_sign

CPU = "cpu"
NAMES = np.array(["kim", "ada", "zed", "bo", "lee", "max", "ann", "tom",
                  "eve", "sam"])


@pytest.fixture(scope="module")
def data():
  rng = np.random.RandomState(42)
  centers = rng.randn(len(NAMES), 20) * 3
  counts = rng.randint(18, 23, len(NAMES))
  X = np.concatenate([centers[i] + rng.randn(n, 20)
                      for i, n in enumerate(counts)])
  y = np.repeat(NAMES, counts)
  order = rng.permutation(len(y))
  Xte = np.concatenate([centers[i] + rng.randn(4, 20)
                        for i in range(len(NAMES))])
  yte = np.repeat(NAMES, 4)
  return X[order], y[order], Xte, yte


def test_class_stats_and_wccn_match_jax(data):
  X, y, _, _ = data
  classes, means = compute_class_avg(X, y, device=CPU)
  jc, jm = jax_scoring.compute_class_avg(X, y)
  np.testing.assert_array_equal(classes, jc)
  assert means.dtype == torch.float64
  close(means, jm, 1e-10, "class means")
  close(compute_within_cov(torch.from_numpy(X), y),
        jax_scoring.compute_within_cov(X, y), 1e-10, "within cov")
  close(compute_wccn(torch.from_numpy(X), y),
        jax_scoring.compute_wccn(X, y), 1e-10, "wccn")


@pytest.mark.parametrize("wccn", [False, True])
def test_vector_normalizer_matches_jax(data, wccn):
  X, y, Xte, _ = data
  vn = VectorNormalizer(wccn=wccn, device=CPU).fit(X, y)
  ref = JaxVectorNormalizer(wccn=wccn).fit(X, y)
  close(vn.transform(Xte), ref.transform(Xte), 1e-10, "transform")
  close(vn.mean, ref.mean, 1e-10, "mean")
  assert (vn.W is None) == (ref.W is None)


def test_scorer_cosine_matches_jax(data):
  X, y, Xte, yte = data
  sc = Scorer(method="cosine", wccn=True, device=CPU).fit(
      torch.from_numpy(X), y)
  ref = JaxScorer(method="cosine", wccn=True).fit(X, y)
  np.testing.assert_array_equal(sc.labels, ref.labels)  # np.unique order
  close(sc.score(Xte), ref.score(Xte), 1e-10, "scores")
  close(sc.predict_proba(Xte), ref.predict_proba(Xte), 1e-10, "proba")
  np.testing.assert_array_equal(sc.predict(Xte), ref.predict(Xte))
  assert np.mean(sc.predict(Xte) == yte) > 0.9


def test_plda_fit_and_scores_match_jax(data):
  X, y, Xte, yte = data
  pl = PLDA(n_phi=8, n_iter=8, device=CPU).fit(X, y)
  ref = JaxPLDA(n_phi=8, n_iter=8).fit(X, y)
  for k in ("mean", "Phi", "Sigma", "_class_latents"):
    assert getattr(pl, k).dtype == torch.float64
    close(getattr(pl, k), getattr(ref, k), 1e-10, k)
  np.testing.assert_array_equal(pl._trained_classes, ref._trained_classes)
  close(pl.score_trials(Xte[:20], Xte[20:]),
        ref.score_trials(Xte[:20], Xte[20:]), 1e-8, "score_trials")
  S = pl.score_matrix(Xte, Xte)
  close(S, ref.score_matrix(Xte, Xte), 1e-8, "score_matrix")
  # the Schur form equals score_trials pairwise (tests/test_ml.py)
  i, j = np.meshgrid(np.arange(0, 40, 3), np.arange(1, 40, 5),
                     indexing="ij")
  close(S[i, j].reshape(-1), pl.score_trials(Xte[i.ravel()],
                                             Xte[j.ravel()]), 1e-8,
        "pairwise")
  close(pl.predict_log_proba(Xte), ref.predict_log_proba(Xte), 1e-10,
        "predict_log_proba")
  np.testing.assert_array_equal(pl.predict(Xte), ref.predict(Xte))
  assert np.mean(pl.predict(Xte) == yte) > 0.9


def test_plda_fit_maximum_likelihood_matches_jax_up_to_column_signs(data):
  X, y, _, _ = data
  pl = PLDA(n_phi=6, device=CPU)
  pl.fit_maximum_likelihood(X, y)
  ref = JaxPLDA(n_phi=6)
  ref.fit_maximum_likelihood(X, y)
  close(up_to_sign(pl.Phi, ref.Phi, axis=0), ref.Phi, 1e-10, "Phi")
  close(pl.Sigma, ref.Sigma, 1e-10, "Sigma")
  close(pl.mean, ref.mean, 1e-10, "mean")
  # scikit-learn's sign convention: the largest |entry| of each column
  Phi = pl.Phi.numpy()
  assert (Phi[np.argmax(np.abs(Phi), 0), np.arange(6)] > 0).all()


def test_bridge_round_trips_plda_and_scorer(data):
  X, y, Xte, _ = data
  ref = JaxPLDA(n_phi=8, n_iter=4).fit(X, y)
  pl = from_jax_plda(ref, CPU)
  close(pl.score_matrix(Xte, Xte), ref.score_matrix(Xte, Xte), 1e-8,
        "JAX's PLDA in the port")
  np.testing.assert_array_equal(pl.predict(Xte), ref.predict(Xte))
  # and back: the port's PLDA state into a JAX PLDA
  mine = PLDA(n_phi=8, n_iter=4, device=CPU).fit(X, y)
  target = JaxPLDA(n_phi=8)
  state = to_jax_plda(mine)
  for k, v in state.pop("normalizer").items():
    setattr(target.normalizer, k, v)
  for k, v in state.items():
    assert not isinstance(v, torch.Tensor)
    setattr(target, k, v)
  close(target.score_matrix(Xte, Xte), mine.score_matrix(Xte, Xte), 1e-8,
        "the port's PLDA in JAX")
  np.testing.assert_array_equal(from_jax_plda(to_jax_plda(mine), CPU)
                                .Sigma.numpy(), mine.Sigma.numpy())
  sref = JaxScorer(wccn=True).fit(X, y)
  sc = from_jax_scorer(sref, CPU)
  close(sc.score(Xte), sref.score(Xte), 1e-10, "JAX's Scorer in the port")
  starget = JaxScorer(wccn=True)
  state = to_jax_scorer(Scorer(wccn=True, device=CPU).fit(X, y))
  for k, v in state.pop("normalizer").items():
    setattr(starget.normalizer, k, v)
  for k, v in state.items():
    setattr(starget, k, v)
  close(starget.score(Xte), sref.score(Xte), 1e-10, "the port's in JAX")


def test_paths_waiting_for_scikit_learn_raise():
  """The paths that waited for scikit-learn's LDA and SVC are ported now
  (tests/test_torch_discriminant.py, tests/test_torch_svm.py): they build;
  an unknown method still raises."""
  assert VectorNormalizer(lda=True, device=CPU).lda
  assert Scorer(method="svm", device=CPU).method == "svm"
  assert Scorer(lda=True, device=CPU).normalizer.lda
  with pytest.raises(ValueError):
    Scorer(method="plda", device=CPU)
