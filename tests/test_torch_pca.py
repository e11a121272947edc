"""The port's incremental PCA (``odin_tpu_torch.preprocessing.calculate_pca``,
a torch ``IncrementalPCA``) against the JAX package's ``calculate_pca``,
which runs scikit-learn's ``IncrementalPCA``, on the same feature store.

Two stores, made with numpy from a seed: log-mel rows of the synthetic
speaker corpus, and Gaussian rows with a decaying spectrum.  Each is fitted
as a stream of equal chunks, with a last chunk that is short, and with a
last chunk shorter than ``n_components`` (skipped by both).  Limits:
components within atol 1e-4 after ``svd_flip``; explained variance, its
ratio, the mean and the variance within rtol 1e-4; singular values within
rtol 1e-4; the attributes' dtypes equal to scikit-learn's.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from odin_tpu.fuel.audio_data import synth_speaker_corpus
from odin_tpu.preprocessing.processor import calculate_pca as jax_pca
from odin_tpu_torch.fuel.databases import MmapArrayWriter
from odin_tpu_torch.fuel.dataset import Dataset
from odin_tpu_torch.ops.features import FeatureConfig, speech_features
from odin_tpu_torch.preprocessing import IncrementalPCA, calculate_pca

torch.set_num_threads(2)

COMP_ATOL = 1e-4
RTOL = 1e-4
N_COMPONENTS = 20


def _speech_rows():
  utts, _ = synth_speaker_corpus(5, 6, seed=2, dur=2.0)
  out = speech_features(np.stack(utts), FeatureConfig(), device="cpu")
  return out["mspec"].reshape(-1, 40).numpy()


def _gaussian_rows():
  rs = np.random.RandomState(4)
  scales = 10.0 ** -np.linspace(0, 2, 40)
  basis = np.linalg.qr(rs.randn(40, 40))[0]
  return ((rs.randn(4800, 40) * scales) @ basis.T + 3.0).astype(np.float32)


ROWS = {"speech": _speech_rows, "gaussian": _gaussian_rows}


def _store(root, rows):
  with MmapArrayWriter(os.path.join(root, "mspec"), shape=(0, 40)) as w:
    w.write(rows)
  return Dataset(root)


@pytest.mark.parametrize("data", sorted(ROWS))
@pytest.mark.parametrize("cut", ["equal", "short_last", "skipped_last"])
def test_incremental_pca_matches_scikit_learn(tmp_path, data, cut):
  rows = ROWS[data]()
  batch = 1200
  n = {"equal": 4 * batch, "short_last": 4 * batch - 900,
       "skipped_last": 3 * batch + N_COMPONENTS - 5}[cut]
  rows = rows[:n]
  assert len(rows) == n
  ds = _store(str(tmp_path), rows)
  want = jax_pca(ds.path, "mspec", n_components=N_COMPONENTS,
                 batch_size=batch)
  got = calculate_pca(ds, "mspec", n_components=N_COMPONENTS,
                      batch_size=batch, device="cpu")
  assert got.n_samples_seen_ == want.n_samples_seen_ == \
      (n if cut != "skipped_last" else 3 * batch)
  for name in ("components_", "singular_values_", "explained_variance_",
               "explained_variance_ratio_", "mean_", "var_"):
    g, w = getattr(got, name), getattr(want, name)
    assert g.dtype == w.dtype and g.shape == w.shape, name
    if name == "components_":
      np.testing.assert_allclose(g, w, rtol=0, atol=COMP_ATOL, err_msg=name)
    else:
      np.testing.assert_allclose(g, w, rtol=RTOL, err_msg=name)
  np.testing.assert_allclose(got.noise_variance_, want.noise_variance_,
                             rtol=RTOL)
  np.testing.assert_allclose(got.transform(rows[:50]),
                             want.transform(rows[:50]), rtol=RTOL, atol=1e-3)
  # the port's object, pickled where JAX pickles scikit-learn's
  with open(os.path.join(ds.path, "mspec_pca.pkl"), "rb") as f:
    loaded = pickle.load(f)
  assert isinstance(loaded, IncrementalPCA)
  np.testing.assert_array_equal(loaded.components_, got.components_)


def test_one_batch_and_float64_data():
  """One float32 batch keeps float32 factors; float64 data stays float64;
  the largest entry of each component is positive (svd_flip)."""
  from sklearn.decomposition import IncrementalPCA as SkPCA
  rows = _gaussian_rows()[:500]
  for x in (rows, rows.astype(np.float64)):
    got = IncrementalPCA(5, device="cpu").partial_fit(x)
    want = SkPCA(n_components=5).partial_fit(x)
    assert got.components_.dtype == want.components_.dtype == x.dtype
    np.testing.assert_allclose(got.components_, want.components_, rtol=0,
                               atol=COMP_ATOL)
    np.testing.assert_allclose(got.explained_variance_,
                               want.explained_variance_, rtol=RTOL)
    top = np.abs(got.components_).argmax(1)
    assert (got.components_[np.arange(5), top] > 0).all()
  with pytest.raises(ValueError, match="n_components"):
    IncrementalPCA(50, device="cpu").partial_fit(rows)
