"""The port's torch estimators (``odin_tpu_torch/bay/vi/estimators.py``)
against the scikit-learn calls that the JAX package's scores make, on the
CPU, with numpy inputs drawn from a seed: latents that are noisy mixes of
dSprites-like factors (3, 6, 40, 32 and 32 values, plus a binary one).

Limits:
- exact: ``train_test_split``'s rows (plain and stratified) and
  ``discretizing``'s uniform bins (``KBinsDiscretizer``);
- ``mutual_info_score``: the same value to 1e-14 (float64 rounding of the
  logs and of the sum, whose order differs);
- ``StandardScaler``: the transformed float32 column within 1e-6;
- ``LogisticRegression``: coefficients within rtol 1e-5 (of the largest)
  of the unique minimiser, scikit-learn run to convergence (tol 1e-14, in
  float64), where at most one prediction may differ (a row within
  rounding of a tie).  The call as the JAX package makes it (lbfgs at tol
  1e-4, on float32 features) stops 6e-4 to 9e-3 (of the largest
  coefficient) short of that minimiser (measured: 2 to 40 classes), so
  against it the predictions are held on all but 2 % of the rows
  (measured up to 1.1 %);
- ``LinearSVC(C=0.01, class_weight='balanced')`` on one standardised
  latent, as SAP fits it: coefficients and intercepts within rtol 1e-3 (of
  the largest) of liblinear's (measured: within 1e-5), and the same
  predictions as liblinear run to convergence (tol 1e-12).  liblinear at
  its default tol 1e-4 is 2e-6 short of that solution, which moves 3 of
  1500 predictions of a 40-class one-against-the-rest argmax (measured):
  against it, all but 0.5 % of the rows;
- ``GradientBoostingClassifier(n_estimators=10)``: where every split has
  one best candidate, scikit-learn's result does not depend on its
  random_state, and the port's importances are within 1e-6 (of the
  largest) and its predictions equal.  Splits of equal gain are common on
  classification residuals, and scikit-learn breaks them by its feature
  visit order (replayed by the port) and, where its float sums round two
  equal gains apart, by that rounding.  There the limit is twice the
  spread of scikit-learn's own importances over four other random states.
  On features that are copies of one another every split ties exactly in
  both, so the visit order alone decides: there the port's chosen feature
  at every node of every tree equals scikit-learn's.

``python tests/test_torch_estimators.py`` prints the measured distances
behind these limits.
"""
import warnings

import numpy as np
import pytest
import torch
from sklearn.ensemble import GradientBoostingClassifier as SkGBT
from sklearn.linear_model import LogisticRegression as SkLR
from sklearn.metrics import mutual_info_score as sk_mi
from sklearn.model_selection import train_test_split as sk_split
from sklearn.preprocessing import KBinsDiscretizer
from sklearn.preprocessing import StandardScaler as SkScaler
from sklearn.svm import LinearSVC as SkSVC

from odin_tpu_torch.bay.vi import estimators as E
from odin_tpu_torch.bay.vi.utils import discretizing

torch.set_num_threads(2)
warnings.filterwarnings("ignore", module="sklearn")

SIZES = (3, 6, 40, 32, 32, 2)
N = 1500


def latents_and_factors(n=N, d=6, seed=0, dtype=np.float32):
  """(z (n, d), factors (n, 6)): each latent a noisy mix of two factors
  scaled to [0, 1]."""
  rng = np.random.RandomState(seed)
  f = np.stack([rng.randint(0, k, n) for k in SIZES], 1)
  u = f / (np.array(SIZES) - 1.0)
  mix = rng.rand(len(SIZES), d) * (rng.rand(len(SIZES), d) < 0.4)
  mix[np.arange(d) % len(SIZES), np.arange(d)] += 1.0
  z = u @ mix + 0.3 * rng.randn(n, d)
  return z.astype(dtype), f


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("test_size", [0.2, 0.3, 0.25])
def test_train_test_split_rows(seed, test_size):
  z, f = latents_and_factors(n=997)
  want = sk_split(z, f, test_size=test_size, random_state=seed)
  got = E.train_test_split(z, torch.tensor(f), test_size=test_size,
                           random_state=seed)
  for a, b in zip(want, got):
    np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("column", [0, 1, 2, 5])
def test_stratified_split_rows(column):
  z, f = latents_and_factors(n=1000)
  y = f[:, column]
  want = sk_split(z, y, test_size=0.3, random_state=1, stratify=y)
  got = E.train_test_split(torch.tensor(z), torch.tensor(y), test_size=0.3,
                           random_state=1, stratify=y)
  for a, b in zip(want, got):
    np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_standard_scaler(dtype):
  z, _ = latents_and_factors(dtype=dtype)
  z[:, 3] = 2.5  # a constant column keeps scale 1
  want = SkScaler().fit_transform(z)
  got = E.StandardScaler().fit_transform(torch.tensor(z)).numpy()
  assert got.dtype == want.dtype
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_bins", [8, 20])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_discretizing_uniform_bins_exact(n_bins, dtype):
  z, _ = latents_and_factors(dtype=dtype)
  z[:, 2] = -1.0
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    want = KBinsDiscretizer(n_bins=n_bins, encode="ordinal",
                            strategy="uniform").fit_transform(z)
  got = discretizing(torch.tensor(z), n_bins=n_bins)
  np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_mutual_info_score():
  z, f = latents_and_factors()
  codes = discretizing(torch.tensor(z), n_bins=8).numpy()
  got = E.mutual_info_matrix(torch.tensor(f), torch.tensor(codes)).numpy()
  want = np.array([[sk_mi(f[:, j], codes[:, i]) for i in range(z.shape[1])]
                   for j in range(f.shape[1])])
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
  assert E.mutual_info_score(f[:, 0], f[:, 0], device="cpu") == \
      pytest.approx(sk_mi(f[:, 0], f[:, 0]), abs=1e-14)
  assert E.mutual_info_score(np.zeros(10), f[:10, 0], device="cpu") == 0.0


@pytest.mark.parametrize("column", [0, 1, 2, 5])
def test_logistic_regression(column):
  z, f = latents_and_factors()
  y = f[:, column]
  port = E.LogisticRegression().fit(torch.tensor(z), torch.tensor(y))
  scale = lambda c: np.abs(c).max()
  tight = SkLR(max_iter=50000, tol=1e-14).fit(z.astype(np.float64), y)
  np.testing.assert_allclose(port.coef_.numpy(), tight.coef_, rtol=0,
                             atol=1e-5 * scale(tight.coef_))
  assert np.sum(port.predict(torch.tensor(z)).numpy() !=
                tight.predict(z.astype(np.float64))) <= 1
  # the call as the JAX package makes it stops short of the minimiser
  # (lbfgs at tol 1e-4 on float32): its predictions may differ on rows near
  # a boundary, measured up to 1.1 % here
  jax_call = SkLR(max_iter=5000, random_state=1).fit(z, y)
  assert np.mean(port.predict(torch.tensor(z)).numpy() !=
                 jax_call.predict(z)) <= 0.02
  proba = port.predict_proba(torch.tensor(z)).numpy()
  np.testing.assert_allclose(proba.sum(1), 1.0, atol=1e-12)
  assert proba.shape == (N, SIZES[column])


def test_logistic_regression_ends_at_the_optimum_in_any_row_order():
  """Near the optimum a Newton step's gain falls below the objective's
  float64 rounding, where a line search accepts or rejects by rounding;
  the fit takes full steps there, so the same rows in another order (other
  roundings, as on another device) reach the same optimum: probabilities
  within 1e-13 (measured 4.4e-16; a stop at the first rejected step left
  them 2e-10 apart on these rows)."""
  rng = np.random.RandomState(0)
  y = np.repeat(np.arange(16), 16)
  X = torch.from_numpy(3.0 * (0.6 * rng.randn(16, 64)[y] +
                              rng.randn(len(y), 64)))
  yt = torch.from_numpy(y)
  probs = []
  for seed in range(6):
    perm = torch.from_numpy(np.random.RandomState(seed).permutation(len(y)))
    probs.append(E.LogisticRegression().fit(X[perm], yt[perm]).predict_proba(
        X).numpy())
  for p in probs[1:]:
    np.testing.assert_allclose(p, probs[0], rtol=0, atol=1e-13)


@pytest.mark.parametrize("latent", [0, 3])
@pytest.mark.parametrize("column", [0, 1, 2, 5])
def test_linear_svc_as_sap_fits_it(latent, column):
  z, f = latents_and_factors()
  x = z[:, latent:latent + 1]
  xs = SkScaler().fit_transform(x)
  y = f[:, column]
  want = SkSVC(C=0.01, max_iter=4000, class_weight="balanced",
               random_state=1).fit(xs, y)
  got = E.LinearSVC(C=0.01, class_weight="balanced").fit(torch.tensor(xs),
                                                         torch.tensor(y))
  w_want = np.concatenate([want.coef_, want.intercept_[:, None]], 1)
  w_got = np.concatenate([got.coef_.numpy(), got.intercept_.numpy()[:, None]],
                         1)
  np.testing.assert_allclose(w_got, w_want, rtol=0,
                             atol=1e-3 * np.abs(w_want).max())
  tight = SkSVC(C=0.01, max_iter=1000000, tol=1e-12,
                class_weight="balanced", random_state=1).fit(xs, y)
  pred = got.predict(torch.tensor(xs)).numpy()
  np.testing.assert_array_equal(pred, tight.predict(xs))
  assert np.mean(pred != want.predict(xs)) <= 0.005


def test_fit_l2_svc_batches_independent_problems():
  """Problems solved together equal the same problems solved apart."""
  rng = np.random.RandomState(3)
  X = torch.tensor(rng.randn(4, 200, 3))
  Y = torch.tensor(np.where(rng.rand(4, 200) < 0.3, 1.0, -1.0))
  C = torch.tensor(rng.rand(4, 200) + 0.1)
  together = E.fit_l2_svc(X, Y, C)
  for b in range(4):
    alone = E.fit_l2_svc(X[b:b + 1], Y[b:b + 1], C[b:b + 1])
    np.testing.assert_allclose(together[b], alone[0], atol=1e-10)


def _sk_importances(z, y, random_state):
  m = SkGBT(n_estimators=10, random_state=random_state).fit(z, y)
  return m, m.feature_importances_


@pytest.mark.parametrize("column", range(len(SIZES)))
def test_gradient_boosting_against_scikit_learn(column):
  z, f = latents_and_factors(n=1200)
  ztr, zte, ftr, fte = sk_split(z, f, test_size=0.2, random_state=1)
  y = ftr[:, column]
  sk, want = _sk_importances(ztr, y, 1)
  spread = max(np.abs(_sk_importances(ztr, y, r)[1] - want).max()
               for r in (2, 3, 4, 5))
  port = E.GradientBoostingClassifier(n_estimators=10, random_state=1).fit(
      torch.tensor(ztr), torch.tensor(y))
  got = port.feature_importances_.numpy()
  bound = max(1e-6 * want.max(), 2 * spread)
  assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(), spread)
  np.testing.assert_allclose(got.sum(), 1.0, atol=1e-12)
  if spread <= 1e-12:  # no tie: the same model
    np.testing.assert_array_equal(port.predict(torch.tensor(zte)).numpy(),
                                  sk.predict(zte))
    np.testing.assert_allclose(port.decision_function(torch.tensor(zte)),
                               sk.decision_function(zte), atol=1e-9)


@pytest.mark.parametrize("column", [0, 1, 2, 5])
def test_gradient_boosting_replays_the_visit_order(column):
  """Four copies of one latent: every split ties across the copies, bit
  for bit in both packages, so each node's feature is the first that
  scikit-learn's splitter visits; the port must pick the same one in
  every node of every tree of every stage, in scikit-learn's depth-first
  order.  One exception: scikit-learn computes a child's impurity from its
  parent's sums, and rounding can leave a node whose residuals are all
  equal above ``EPSILON``, so it searches (and splits, at no gain) a node
  the port leaves a leaf.  Its draws for that node then shift the visit
  order of the tree's later nodes, so a tree is compared up to such a
  node (which changes no prediction)."""
  z, f = latents_and_factors(n=600)
  x = np.repeat(z[:, :1], 4, 1)
  y = f[:, column]
  sk = SkGBT(n_estimators=4, random_state=3).fit(x, y)
  port = E.GradientBoostingClassifier(n_estimators=4, random_state=3).fit(
      torch.tensor(x), torch.tensor(y))
  compared = cut = 0
  for stage, tree in enumerate(port.trees_):
    for k in range(tree["value"].shape[0]):
      t = sk.estimators_[stage, k].tree_
      order = []

      def walk(node, h):
        order.append((h, node))
        if t.children_left[node] != -1:
          walk(t.children_left[node], 2 * h + 1)
          walk(t.children_right[node], 2 * h + 2)

      walk(0, 0)
      for h, node in order:
        split = t.children_left[node] != -1
        if split and t.impurity[node] < 1e-12:
          cut += 1
          break  # a node of equal residuals searched on rounding
        assert bool(tree["is_split"][k, h]) == split, (stage, k, h)
        if split:
          assert int(tree["feature"][k, h]) == t.feature[node], (stage, k, h)
          assert float(tree["threshold"][k, h]) == t.threshold[node]
          compared += 1
  assert compared >= 4 * port.trees_[0]["value"].shape[0]
  if not cut:  # every node compared: the importances are the same too
    np.testing.assert_allclose(port.feature_importances_.numpy(),
                               sk.feature_importances_, atol=1e-9)
  np.testing.assert_array_equal(port.predict(torch.tensor(x)).numpy(),
                                sk.predict(x))


def test_boosting_probabilities_are_the_same_bits_as_numpy():
  """The boosted trees' residuals come from ``_exp_nonpositive`` and
  ``_pairwise_sum``, built from IEEE-rounded products, sums and quotients
  only, so any IEEE implementation of the same steps gives the same bits:
  here numpy's, bit for bit.  The exp is within 2 ulp of numpy's from 0
  down to -708, the sums within 1e-12 of numpy's, the probabilities within
  2e-15 of the softmax and the sigmoid."""
  rng = np.random.RandomState(0)
  x = np.concatenate([-np.geomspace(1e-300, 708.0, 20000), [0.0, -708.0],
                      -rng.rand(20000) * 40])
  got = E._exp_nonpositive(torch.tensor(x)).numpy()
  k = np.round(x * (1.0 / np.log(2.0)))
  r = (x - k * E._LN2_HI) - k * E._LN2_LO
  p = np.full_like(r, E._EXP_TAYLOR[-1])
  for c in reversed(E._EXP_TAYLOR[:-1]):
    p = p * r + c
  np.testing.assert_array_equal(got, np.ldexp(p, k.astype(np.int64)))
  np.testing.assert_allclose(got, np.exp(x), rtol=4.5e-16, atol=0)
  for n in (1, 2, 7, 64, 1000):
    v = rng.randn(3, n)
    w = np.pad(v, ((0, 0), (0, (1 << (n - 1).bit_length()) - n)))
    while w.shape[1] > 1:
      w = w[:, :w.shape[1] // 2] + w[:, w.shape[1] // 2:]
    np.testing.assert_array_equal(E._pairwise_sum(torch.tensor(v)).numpy(),
                                  w[:, 0])
    np.testing.assert_allclose(w[:, 0], v.sum(1), rtol=1e-12, atol=1e-12)
  raw = rng.randn(50, 5) * 10
  want = np.exp(raw - raw.max(1, keepdims=True))
  np.testing.assert_allclose(
      E._portable_probabilities(torch.tensor(raw)).numpy(),
      want / want.sum(1, keepdims=True), rtol=2e-15, atol=1e-300)
  np.testing.assert_allclose(
      E._portable_probabilities(torch.tensor(raw[:, :1])).numpy(),
      1 / (1 + np.exp(-raw[:, :1])), rtol=2e-15, atol=1e-300)


def test_estimators_refuse_one_class():
  z, _ = latents_and_factors(n=50)
  y = torch.zeros(50, dtype=torch.int64)
  for est in (E.LogisticRegression(), E.LinearSVC(),
              E.GradientBoostingClassifier(n_estimators=2)):
    with pytest.raises(ValueError):
      est.fit(torch.tensor(z), y)
  with pytest.raises(NotImplementedError):
    E.GradientBoostingClassifier(subsample=0.8)


def report():
  """Print the measured distances behind this module's limits."""
  z, f = latents_and_factors(n=1200)
  ztr, _, ftr, _ = sk_split(z, f, test_size=0.2, random_state=1)
  for column, size in enumerate(SIZES):
    y = ftr[:, column]
    want = _sk_importances(ztr, y, 1)[1]
    spread = max(np.abs(_sk_importances(ztr, y, r)[1] - want).max()
                 for r in (2, 3, 4, 5))
    got = E.GradientBoostingClassifier(n_estimators=10, random_state=1).fit(
        torch.tensor(ztr), torch.tensor(y)).feature_importances_.numpy()
    print(f"GBT {size:2d} values: port - scikit-learn "
          f"{np.abs(got - want).max():.3g}, scikit-learn over random "
          f"states {spread:.3g}")
  z, f = latents_and_factors()
  for column, size in enumerate(SIZES):
    y = f[:, column]
    tight = SkLR(max_iter=50000, tol=1e-14).fit(z.astype(np.float64), y)
    made = SkLR(max_iter=5000, random_state=1).fit(z, y)
    port = E.LogisticRegression().fit(torch.tensor(z), torch.tensor(y))
    scale = np.abs(tight.coef_).max()
    print(f"LogisticRegression {size:2d} classes: JAX's call from the "
          f"minimiser {np.abs(made.coef_ - tight.coef_).max() / scale:.3g}, "
          f"port {np.abs(port.coef_.numpy() - tight.coef_).max() / scale:.3g}"
          f"; predictions apart from JAX's call "
          f"{np.mean(port.predict(torch.tensor(z)).numpy() != made.predict(z)):.4f}")
  for latent in (0, 3):
    xs = SkScaler().fit_transform(z[:, latent:latent + 1])
    for column, size in enumerate(SIZES):
      y = f[:, column]
      made = SkSVC(C=0.01, max_iter=4000, class_weight="balanced",
                   random_state=1).fit(xs, y)
      tight = SkSVC(C=0.01, max_iter=1000000, tol=1e-12,
                    class_weight="balanced", random_state=1).fit(xs, y)
      port = E.LinearSVC(C=0.01, class_weight="balanced").fit(
          torch.tensor(xs), torch.tensor(y))
      w = lambda m: np.concatenate([np.asarray(m.coef_), np.asarray(
          m.intercept_).reshape(-1, 1)], 1)
      scale = np.abs(w(tight)).max()
      print(f"LinearSVC latent {latent}, {size:2d} classes: liblinear's "
            f"default from tol 1e-12 {np.abs(w(made) - w(tight)).max() / scale:.3g}"
            f", port {np.abs(w(port) - w(tight)).max() / scale:.3g}; "
            f"predictions apart from the default "
            f"{int(np.sum(port.predict(torch.tensor(xs)).numpy() != made.predict(xs)))}"
            f" of {len(y)}")


if __name__ == "__main__":
  report()
