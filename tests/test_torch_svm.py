"""The port's ``SVC`` (``odin_tpu_torch/ml/svm.py``) against scikit-learn
1.9's (libsvm), and ``Scorer(method='svm')`` against the JAX package's, on
the CPU.

Data: 2 and 4 Gaussian classes of 30 rows in 5 dims.

Tolerances:

- decision values: 1e-3 of the largest magnitude.  libsvm stops when the
  maximal KKT violation falls below ``tol`` = 1e-3, so two SMO runs that
  visit the variables in another order (libsvm shrinks, the port does
  not) may stop at duals whose decision values differ by that order; with
  a linear kernel w is unique and the runs here agree to 2e-15, with the
  rbf kernel to 6e-5 of the largest value.  Predictions and support
  vectors equal.  The dual coefficients and intercepts, which the stop
  bounds less tightly: 1e-2 (measured 1e-3 with the rbf kernel).
- probabilities from scikit-learn's own ``probA_``/``probB_`` (through the
  bridge): 1e-6 (the same sigmoid and Wu-Lin-Weng coupling, its stop at
  0.005/k on the same numbers).
- probabilities of the port's own fit: its five folds are not libsvm's
  (libsvm shuffles with its own generator, unseeded in JAX's ``Scorer``),
  so they are held to scikit-learn's within twice the largest distance
  between scikit-learn's own probabilities over six seeds of its shuffle
  (measured 0.049-0.076 on this data; the port lay 0.038-0.050 from seed
  0's).
"""
import warnings

import numpy as np
import pytest
import torch
from sklearn.svm import SVC as SkSVC

from odin_tpu.ml import Scorer as JaxScorer
from odin_tpu_torch.ml import Scorer, fast_svc
from odin_tpu_torch.ml.svm import SVC, multiclass_probability
from odin_tpu_torch.weights import (from_jax_scorer, from_jax_svc,
                                    to_jax_scorer, to_jax_svc)

from torch_ml_common import close

CPU = "cpu"
DEC_TOL = 1e-3
DUAL_TOL = 1e-2
PROB_TOL = 1e-6
SEEDS = range(6)


def _data(K, seed, n=30, d=5):
  rng = np.random.RandomState(seed)
  X = np.concatenate([rng.randn(n, d) + rng.randn(d) * 1.5
                      for _ in range(K)])
  return X, np.repeat(np.arange(K), n)


def _sk(**kw):
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")  # probability=True is deprecated in 1.9
    return SkSVC(**kw)


def _np(t):
  return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_svc_decision_values_and_predictions(K, kernel):
  X, y = _data(K, K)
  Xt, _ = _data(K, K + 10, n=10)
  want = _sk(kernel=kernel).fit(X, y)
  got = SVC(kernel=kernel, device=CPU).fit(X, y)
  close(got.decision_function(Xt), want.decision_function(Xt), DEC_TOL)
  np.testing.assert_array_equal(got.predict(Xt), want.predict(Xt))
  np.testing.assert_array_equal(got.n_support_, want.n_support_)
  np.testing.assert_array_equal(got.support_, want.support_)
  close(got.intercept_, want.intercept_, DUAL_TOL)
  close(got.dual_coef_, want.dual_coef_, DUAL_TOL)
  assert got.score(Xt, want.predict(Xt)) == 1.0


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_svc_probabilities(K, kernel):
  X, y = _data(K, K)
  Xt, _ = _data(K, K + 10, n=10)
  sk = [_sk(kernel=kernel, probability=True, random_state=s).fit(X, y)
        for s in SEEDS]
  probs = [m.predict_proba(Xt) for m in sk]
  spread = max(np.abs(a - b).max() for a in probs for b in probs)
  got = SVC(kernel=kernel, probability=True, random_state=0,
            device=CPU).fit(X, y)
  p = _np(got.predict_proba(Xt))
  assert np.abs(p - probs[0]).max() <= 2 * spread
  np.testing.assert_allclose(p.sum(1), 1.0, atol=1e-12)
  close(got.predict_log_proba(Xt), np.log(p), 1e-12)
  # scikit-learn's own sigmoids through the port's coupling
  mirror = from_jax_svc(sk[0], CPU)
  close(mirror.predict_proba(Xt), probs[0], PROB_TOL, "coupled")
  close(mirror.decision_function(Xt), sk[0].decision_function(Xt), 1e-12)
  back = from_jax_svc(to_jax_svc(got), CPU)
  close(back.predict_proba(Xt), p, 1e-12)
  close(back.decision_function(Xt), _np(got.decision_function(Xt)), 1e-12)


def test_svc_other_kernels_and_shapes():
  X, y = _data(3, 7)
  for kw in (dict(kernel="poly", degree=2, gamma="auto", coef0=1.0),
             dict(kernel="sigmoid", gamma=0.05), dict(kernel="rbf", C=10.0),
             dict(kernel="linear", decision_function_shape="ovo")):
    want = _sk(**kw).fit(X, y)
    got = SVC(device=CPU, **kw).fit(X, y)
    close(got.decision_function(X), want.decision_function(X), DEC_TOL)
    np.testing.assert_array_equal(got.predict(X), want.predict(X))
  with pytest.raises(AttributeError):
    SVC(device=CPU).fit(X, y).predict_proba(X)


def test_multiclass_probability_matches_libsvm_on_one_row():
  """The coupling of a consistent set of pairwise probabilities returns
  the probabilities they came from."""
  p = np.array([0.5, 0.3, 0.15, 0.05])
  r = p[:, None] / (p[:, None] + p[None, :])
  got = multiclass_probability(torch.from_numpy(r)[None])[0].numpy()
  np.testing.assert_allclose(got, p, atol=1e-3)


def test_fast_svc():
  X, y = _data(3, 8)
  close(fast_svc(X, y, device=CPU).decision_function(X),
        _sk(kernel="linear").fit(X, y).decision_function(X), DEC_TOL)


def test_svm_scorer_matches_jax():
  rng = np.random.RandomState(12)
  centres = rng.randn(4, 8) * 2
  X = np.concatenate([rng.randn(20, 8) + c for c in centres])
  y = np.repeat(np.array(["d", "b", "a", "c"]), 20)
  Xt = np.concatenate([rng.randn(6, 8) + c for c in centres])
  runs = []
  for seed in SEEDS:  # JAX's SVC draws its shuffle from numpy's global state
    np.random.seed(seed)
    with warnings.catch_warnings():
      warnings.simplefilter("ignore")
      runs.append(JaxScorer(method="svm", wccn=True).fit(X, y))
  probs = [s.predict_proba(Xt) for s in runs]
  spread = max(np.abs(a - b).max() for a in probs for b in probs)
  got = Scorer(method="svm", wccn=True, device=CPU).fit(X, y)
  np.testing.assert_array_equal(got.labels, runs[0].labels)
  assert np.abs(_np(got.predict_proba(Xt)) - probs[0]).max() <= 2 * spread
  close(got.model.decision_function(got.normalizer.transform(Xt)),
        runs[0].model.decision_function(runs[0].normalizer.transform(Xt)),
        DEC_TOL)
  close(got.score(Xt), runs[0].score(Xt), 1e-10, "cosine scores")
  close(from_jax_scorer(runs[0], CPU).predict_proba(Xt), probs[0], PROB_TOL)
  back = from_jax_scorer(to_jax_scorer(got), CPU)
  close(back.predict_proba(Xt), _np(got.predict_proba(Xt)), 1e-12)
