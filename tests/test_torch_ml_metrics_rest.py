"""The rest of the port's ``backend/metrics.py`` (``roc_curve_``/
``roc_curve``, ``prc_curve``, ``binary_accuracy``,
``categorical_accuracy``, ``confusion_matrix``, ``LER``) and
``backend/maths.py`` (``to_llh``, ``to_llr``) against the JAX package's on
the CPU, from the same numpy-seeded inputs.

Tolerances: the curves, accuracies, confusion matrices and label error
rates are counts and ratios of counts, computed in float64 by both
packages: equal (the curves' thresholds are the input scores).  ``to_llh``
and ``to_llr`` run in float32 in both packages (a logsumexp over the other
classes): within 1e-6 of the largest magnitude.
"""
import warnings

import numpy as np
import pytest
import torch

from odin_tpu.backend import maths as J_maths
from odin_tpu.backend import metrics as J
from odin_tpu_torch.backend import maths as P_maths
from odin_tpu_torch.backend import metrics as P

from torch_ml_common import close


def _scores(seed, n=200, tie_grid=0.05):
  """Labels in {0, 1} and scores rounded to a grid, so that many tie."""
  rng = np.random.RandomState(seed)
  y = rng.randint(0, 2, n)
  s = np.round((rng.randn(n) + y) / tie_grid) * tie_grid
  return y, s


def _equal(got, want):
  for g, w in zip(got, want):
    np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_roc_curve_with_ties(seed, as_tensor):
  y, s = _scores(seed)
  got = P.roc_curve_(y, torch.from_numpy(s) if as_tensor else s)
  _equal(got, J.roc_curve_(y, s))
  assert got[2][0] == np.inf
  assert P.roc_curve is P.roc_curve_


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_prc_curve_with_ties(seed, as_tensor):
  y, s = _scores(seed)
  got = P.prc_curve(y, torch.from_numpy(s) if as_tensor else s)
  _equal(got, J.prc_curve(y, s))
  assert got[0][-1] == 1.0 and got[1][-1] == 0.0


def test_curves_with_a_pos_label_and_labels_in_minus_one_one():
  y, s = _scores(5)
  _equal(P.roc_curve(2 * y - 1, s), J.roc_curve(2 * y - 1, s))
  _equal(P.roc_curve(y + 3, s, pos_label=3), J.roc_curve(y + 3, s,
                                                         pos_label=3))
  _equal(P.prc_curve(y + 3, s, pos_label=4), J.prc_curve(y + 3, s,
                                                         pos_label=4))
  with pytest.raises(ValueError):
    P.roc_curve(y + 3, s)


def test_curves_with_one_class():
  """No negatives: the ROC's false-positive rates are NaN; no positives:
  the precision-recall curve's recall is 1 until its last point."""
  s = np.linspace(0, 1, 20)
  ones = np.ones(20, int)
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    got, want = P.roc_curve(ones, s), J.roc_curve(ones, s)
    np.testing.assert_array_equal(np.isnan(got[0]), np.isnan(want[0]))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    _equal(P.prc_curve(np.zeros(20, int), s),
           J.prc_curve(np.zeros(20, int), s))


@pytest.mark.parametrize("dtype", [np.int64, np.float32, np.bool_])
def test_binary_accuracy_casts_to_the_labels_dtype(dtype):
  rng = np.random.RandomState(3)
  y = rng.randint(0, 2, 100).astype(dtype)
  p = rng.rand(100)
  for thr in (0.3, 0.5, 0.8):
    assert P.binary_accuracy(y, p, thr) == J.binary_accuracy(y, p, thr)
  assert P.binary_accuracy(torch.from_numpy(y), torch.from_numpy(p)) == \
      J.binary_accuracy(y, p)


def test_categorical_accuracy():
  rng = np.random.RandomState(4)
  y = rng.randint(0, 5, 80)
  logits = rng.randn(80, 5)
  onehot = np.eye(5)[y]
  for a, b in ((y, logits), (onehot, logits), (y, y[::-1].copy()),
               (onehot, rng.randint(0, 5, 80))):
    assert P.categorical_accuracy(a, b) == J.categorical_accuracy(a, b)
  assert P.categorical_accuracy(torch.from_numpy(y),
                                torch.from_numpy(logits)) == \
      J.categorical_accuracy(y, logits)


@pytest.mark.parametrize("normalize", [False, True])
def test_confusion_matrix(normalize):
  rng = np.random.RandomState(6)
  yt = rng.randint(0, 4, 60)
  yp = rng.randint(1, 6, 60)  # labels the truth lacks, and the other way
  for labels in (None, [5, 0, 2], np.array([3, 1])):
    got = P.confusion_matrix(yt, yp, labels=labels, normalize=normalize)
    want = J.confusion_matrix(yt, yp, labels=labels, normalize=normalize)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
  names = np.array(["b", "a", "c"])
  np.testing.assert_array_equal(
      P.confusion_matrix(names[yt % 3], names[yp % 3]),
      J.confusion_matrix(names[yt % 3], names[yp % 3]))


def test_label_error_rate():
  truth = ["kitten", "sitting", "", "flaw", [1, 2, 3, 4]]
  pred = ["sitting", "kitten", "abc", "lawn", [1, 3, 4]]
  assert P.LER(truth, pred) == J.LER(truth, pred)
  assert P.LER(truth, pred, return_mean=False) == \
      J.LER(truth, pred, return_mean=False)
  t = [torch.tensor([1, 2, 3]), torch.tensor([4, 4])]
  p = [torch.tensor([1, 3]), torch.tensor([4, 5, 4])]
  assert P.LER(t, p) == J.LER([[1, 2, 3], [4, 4]], [[1, 3], [4, 5, 4]])


@pytest.mark.parametrize("n_classes", [2, 3, 7])
def test_to_llh_and_to_llr(n_classes):
  rng = np.random.RandomState(n_classes)
  p = rng.dirichlet(np.ones(n_classes), 50).astype("f")
  logits = rng.randn(50, n_classes).astype("f") * 3
  close(P_maths.to_llh(p, device="cpu"), np.asarray(J_maths.to_llh(p)), 1e-6)
  for x in (p, logits, np.log(p)):
    got = P_maths.to_llr(torch.from_numpy(x))
    assert got.dtype == torch.float32
    close(got, np.asarray(J_maths.to_llr(x)), 1e-6)


def test_the_metric_names_are_the_jax_packages():
  assert P.__all__ == J.__all__
  for name in J.__all__:
    assert callable(getattr(P, name)), name
