"""The port's ``Ivector`` (``odin_tpu_torch/ml/ivector.py``) against the JAX
package's (``odin_tpu/ml/ivector.py``) on the CPU, and their caches.

Data: tests/test_ml.py's utterance layout (tests/torch_ml_common.py),
nmix 8, tv_dim 8, five T-matrix iterations.  (At nmix 4 the final level of
this data drifts slowly for some 30 iterations and the two packages stop
one iteration apart on the llk test; tests/test_torch_gmm_tmat.py holds
that trajectory iteration by iteration.)

Tolerances: the i-vectors of the two packages' own fits agree to 1e-4 of
their largest magnitude up to a sign per dimension (fp32 E-steps through
the whole EM, tests/test_torch_gmm_tmat.py; the SVD's signs may differ);
i-vectors recomputed from the other package's cached UBM, statistics and
T-matrix agree to 1e-5 (one fp32 pass, no sign to choose); i-vectors read
back from a cache are bitwise those written.
"""
import shutil

import numpy as np
import pytest
import torch

from odin_tpu.ml import Ivector as JaxIvector
from odin_tpu_torch.ml import Ivector, Scorer

from torch_ml_common import close, up_to_sign, utterances

CPU = "cpu"
KW = dict(nmix=8, tv_dim=8, niter_tmat=5, batch_size=2400)


@pytest.fixture(scope="module")
def data():
  return utterances()


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory, data):
  """A cache directory written by the JAX package, and its i-vectors."""
  path = tmp_path_factory.mktemp("jax") / "ivec"
  ivecs = JaxIvector(path=str(path), **KW).fit_transform(data[0])
  return path, ivecs


def test_fit_transform_matches_jax(data, jax_cache):
  utts, labels = data
  want = jax_cache[1]
  got = Ivector(device=CPU, **KW).fit_transform(utts)
  assert got.dtype == torch.float32 and got.shape == want.shape
  close(up_to_sign(got, want, axis=0), want, 1e-4, "i-vectors")
  # speaker-discriminative, as tests/test_ml.py asks of JAX's
  scorer = Scorer(wccn=True, device=CPU).fit(got[:36], labels[:36])
  assert np.mean(scorer.predict(got[36:]) == labels[36:]) > 0.8
  # tensors in, the same i-vectors
  again = Ivector(device=CPU, **KW).fit_transform(
      [torch.from_numpy(u) for u in utts])
  np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_a_jax_cache_loads_in_the_port(tmp_path, data, jax_cache):
  utts = data[0]
  path, want = jax_cache
  port = Ivector(path=str(path), device=CPU, **KW)
  np.testing.assert_array_equal(port.fit_transform(utts).numpy(), want)
  assert port.gmm.llk_history == []  # loaded, not fitted
  # without ivecs.npy the port extracts them from JAX's UBM, stats and Tm
  copy = tmp_path / "copy"
  shutil.copytree(path, copy)
  (copy / "ivecs.npy").unlink()
  close(Ivector(path=str(copy), device=CPU, **KW).fit_transform(utts), want,
        1e-5, "from JAX's stages")
  assert np.load(copy / "ivecs.npy").dtype == np.float32


def test_a_port_cache_loads_in_jax(tmp_path, data):
  utts = data[0]
  path = tmp_path / "ivec"
  port = Ivector(path=str(path), device=CPU, **KW)
  ivecs = port.fit_transform(utts).numpy()
  assert sorted(p.name for p in path.iterdir()) == [
      "gmm.pkl", "ivecs.npy", "stats.npz", "tmatrix.pkl"]
  np.testing.assert_array_equal(
      JaxIvector(path=str(path), **KW).fit_transform(utts), ivecs)
  (path / "ivecs.npy").unlink()
  close(JaxIvector(path=str(path), **KW).fit_transform(utts), ivecs, 1e-5,
        "JAX from the port's stages")
  # a second port Ivector reloads every stage: bitwise the same
  again = Ivector(path=str(path), device=CPU, **KW)
  np.testing.assert_array_equal(again.fit_transform(utts).numpy(),
                                np.load(path / "ivecs.npy"))
  assert again.gmm.llk_history == []
  np.testing.assert_array_equal(again.transform(utts[:7]).numpy(),
                                port.transform(utts[:7]).numpy())
