"""The port's ``RandomForestClassifier`` (``odin_tpu_torch/ml/forest.py``)
and ``fast_rf_classifier`` against the JAX package's (scikit-learn 1.9's
forest at 100 trees, ``random_state=1``) on the CPU.

Data: Gaussian classes (3-6 classes, 9-24 features, 120-300 rows, float32
and rounded copies with many tied values).

Tolerance: none.  The port replays scikit-learn's seeds, bootstraps and
feature draws, and computes each split's Gini proxy expression for
expression from integer class weights, so every tree has scikit-learn's
nodes, features and thresholds; the probabilities are the same sums of
leaf fractions (1e-15 allowed for the order of the sum over trees).
"""
import numpy as np
import pytest
from sklearn.ensemble import RandomForestClassifier as SkRF

from odin_tpu.ml import fast_rf_classifier as jax_rf
from odin_tpu_torch.ml import fast_rf_classifier
from odin_tpu_torch.ml.forest import RandomForestClassifier
from odin_tpu_torch.weights import from_jax_forest, to_jax_forest

CPU = "cpu"
SUM_TOL = 1e-15


def _data(n, d, K, seed, decimals=None):
  rng = np.random.RandomState(seed)
  X = rng.randn(n, d) + np.repeat(rng.randn(K, d), -(-n // K), 0)[:n] * 0.8
  if decimals is not None:
    X = np.round(X, decimals)
  return X.astype(np.float32), np.repeat(np.arange(K), -(-n // K))[:n]


CASES = {"3x9": (120, 9, 3, None), "5x16": (300, 16, 5, None),
         "6x24-ties": (240, 24, 6, 0)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fast_rf_classifier_matches_jax(case):
  n, d, K, decimals = CASES[case]
  X, y = _data(n, d, K, seed=n, decimals=decimals)
  Xt, _ = _data(80, d, K, seed=n + 1, decimals=decimals)
  want = jax_rf(X, y)
  got = fast_rf_classifier(X, y, device=CPU)
  assert [e.tree_.node_count for e in want.estimators_] == \
      list(got.n_nodes_)
  np.testing.assert_allclose(got.predict_proba(Xt).numpy(),
                             want.predict_proba(Xt), rtol=0, atol=SUM_TOL)
  np.testing.assert_array_equal(got.predict(Xt), want.predict(Xt))
  assert got.score(X, y) == want.score(X, y)


def test_forest_options():
  X, y = _data(150, 10, 3, seed=5)
  for kw in (dict(max_features=None), dict(max_depth=3),
             dict(bootstrap=False), dict(min_samples_leaf=3),
             dict(max_features="log2", min_samples_split=5)):
    want = SkRF(n_estimators=12, random_state=3, **kw).fit(X, y)
    got = RandomForestClassifier(n_estimators=12, random_state=3,
                                 device=CPU, **kw).fit(X, y)
    np.testing.assert_allclose(got.predict_proba(X).numpy(),
                               want.predict_proba(X), rtol=0, atol=SUM_TOL)
  with pytest.raises(NotImplementedError):
    RandomForestClassifier(criterion="entropy")


def test_string_labels():
  X, y = _data(90, 6, 3, seed=6)
  names = np.array(["zed", "amy", "bob"])[y]
  want = SkRF(n_estimators=10, random_state=1).fit(X, names)
  got = RandomForestClassifier(n_estimators=10, random_state=1,
                               device=CPU).fit(X, names)
  np.testing.assert_array_equal(got.predict(X), want.predict(X))


def test_forest_bridge_round_trip():
  X, y = _data(200, 12, 4, seed=7)
  want = SkRF(n_estimators=20, random_state=1).fit(X, y)
  np.testing.assert_allclose(from_jax_forest(want, CPU).predict_proba(
      X).numpy(), want.predict_proba(X), rtol=0, atol=SUM_TOL)
  got = RandomForestClassifier(n_estimators=20, random_state=1,
                               device=CPU).fit(X, y)
  back = to_jax_forest(got)
  # the port's trees in scikit-learn's node order are scikit-learn's trees
  for tree, est in zip(back["estimators_"], want.estimators_):
    t = est.tree_
    np.testing.assert_array_equal(tree["children_left"], t.children_left)
    np.testing.assert_array_equal(tree["children_right"], t.children_right)
    np.testing.assert_array_equal(tree["feature"], t.feature)
    np.testing.assert_array_equal(tree["threshold"], t.threshold)
    np.testing.assert_allclose(tree["value"], t.value, rtol=0, atol=1e-15)
  np.testing.assert_allclose(from_jax_forest(back, CPU).predict_proba(
      X).numpy(), got.predict_proba(X).numpy(), rtol=0, atol=SUM_TOL)


@pytest.mark.parametrize("max_features", [None, 5, 1])
def test_native_splitter_draws_equal_the_python_replay(max_features):
  """``csrc/splitter_draws.cpp`` (built with g++ at first use) replays the
  same draws as the Python ``_SplitterDraws``: the visited features, the
  constant counts and every tree's state after 40 nodes."""
  from odin_tpu_torch.bay.vi.estimators import SplitterDrawsBatch
  rng = np.random.RandomState(0)
  seeds = rng.randint(0, 2 ** 31 - 1, 7)
  native, python = SplitterDrawsBatch(seeds, 30), SplitterDrawsBatch(seeds,
                                                                     30)
  for _ in range(40):
    rows = np.sort(rng.choice(7, rng.randint(1, 8), replace=False))
    known = rng.randint(0, 5, len(rows))
    constant = rng.rand(len(rows), 30) < 0.2
    a = native.visit(rows, known, constant, max_features, native=True)
    b = python.visit(rows, known, constant, max_features, native=False)
    for x, y in zip(a, b):
      np.testing.assert_array_equal(x, y)
  for name in ("states", "features", "constant_features"):
    np.testing.assert_array_equal(getattr(native, name),
                                  getattr(python, name))
