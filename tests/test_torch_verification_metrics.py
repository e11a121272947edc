"""The port's verification metrics (``odin_tpu_torch/backend/metrics.py``:
``det_curve``, ``compute_EER``, ``compute_minDCF``, ``compute_AUC``,
``compute_Cnorm``, ``compute_Cavg``) against the JAX package's
(``odin_tpu/backend/metrics.py``) on the CPU, on trials with tied scores.

The port returns what JAX returns, from arrays or tensors: the same
thresholds, ties grouped the same way (one point per distinct score), the
rates as the same float64 divisions of counts, so equal bitwise; EER,
minDCF, AUC and the costs are JAX's numpy code on those values, so equal
too.
"""
import numpy as np
import pytest
import torch

from odin_tpu.backend import metrics as jax_metrics
from odin_tpu_torch.backend import (compute_AUC, compute_Cavg, compute_Cnorm,
                                    compute_EER, compute_minDCF, det_curve)


def trials(seed, n=400, levels=12):
  """Scores rounded to `levels` values per unit, so that many tie, target
  and non-target alike; labels 1 (target) and 0."""
  rng = np.random.RandomState(seed)
  y = (rng.rand(n) < 0.3).astype(np.int64)
  scores = np.round((rng.randn(n) + 1.5 * y) * levels) / levels
  return y, scores


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_det_eer_mindcf_auc_match_jax(seed, as_tensor):
  y, scores = trials(seed)
  assert len(np.unique(scores)) < len(scores) // 3  # ties, many
  want = jax_metrics.det_curve(y, scores)
  args = (torch.from_numpy(y), torch.from_numpy(scores)) if as_tensor \
      else (y, scores)
  got = det_curve(*args)
  for g, w in zip(got, want):
    assert isinstance(g, np.ndarray)
    np.testing.assert_array_equal(g, w)
  Pfa, Pmiss, _ = got
  assert compute_EER(Pfa, Pmiss) == jax_metrics.compute_EER(*want[:2])
  for kw in ({}, dict(Cmiss=10.0, Cfa=1.0, Ptrue=0.01)):
    assert compute_minDCF(Pfa, Pmiss, **kw) == \
        jax_metrics.compute_minDCF(*want[:2], **kw)
  for reorder in (False, True):
    assert compute_AUC(Pfa, 1 - Pmiss, reorder=reorder) == \
        jax_metrics.compute_AUC(want[0], 1 - want[1], reorder=reorder)
  # tensors of rates are taken too
  assert compute_EER(torch.from_numpy(Pfa), torch.from_numpy(Pmiss)) == \
      compute_EER(Pfa, Pmiss)


def test_det_curve_pos_label_and_all_tied():
  y = np.array([2, 1, 2, 1, 2])
  scores = np.array([0.5, 0.5, 0.5, 0.5, 0.5])
  for pos_label in (None, 1):
    want = jax_metrics.det_curve(y, scores, pos_label=pos_label)
    got = det_curve(y, scores, pos_label=pos_label)
    for g, w in zip(got, want):
      np.testing.assert_array_equal(g, w)
  assert len(got[2]) == 1  # one distinct score, one threshold


@pytest.mark.parametrize("as_tensor", [False, True])
def test_cnorm_and_cavg_match_jax(as_tensor):
  rng = np.random.RandomState(3)
  y = rng.randint(0, 4, 300)
  llr = np.round(rng.randn(300, 4) * 4 + 3 * np.eye(4)[y]) / 4  # ties at 0
  args = (torch.from_numpy(y), torch.from_numpy(llr)) if as_tensor \
      else (y, llr)
  got = compute_Cnorm(*args)
  want = jax_metrics.compute_Cnorm(y, llr)
  assert got[0] == want[0]
  np.testing.assert_array_equal(got[1], want[1])
  for kw in ({}, dict(cluster_idx=[[0, 1], [1, 2, 3]], Ptar=0.3)):
    got = compute_Cavg(*args[::-1], **kw)
    want = jax_metrics.compute_Cavg(llr, y, **kw)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
