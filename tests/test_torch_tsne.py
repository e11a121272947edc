"""The port's t-SNE (``odin_tpu_torch/ml/tsne.py``, ``ml.fast_tsne``)
against scikit-learn's ``TSNE`` as the JAX package calls it, on the CPU, on
300 rows of 10 latents that are noisy mixes of five dSprites-like factors
(perplexity 30, so 91 neighbours a row).

Limits, as measured: P within 1e-6 of scikit-learn's
``_joint_probabilities_nn`` (measured: 4e-19), and one gradient within 1e-6
(of the largest) of ``_kl_divergence``'s on the same P and Y (measured:
5e-18), its KL within rtol 1e-6.  The trajectory is chaotic and
scikit-learn's gradient is Barnes-Hut's, so the final embedding is held by
its KL within 5 % of scikit-learn's ``kl_divergence_`` (measured: 2.3 %,
0.9342 against 0.9133, both after 1000 iterations) and its
``trustworthiness(k=5)`` within 0.02 of scikit-learn's embedding's
(measured: 0.006).  The port's ``trustworthiness`` equals
scikit-learn's (to 1e-12), and the JAX package's ``fast_tsne`` call
(``perplexity=min(30, n − 1)``, 150 rows, 500 iterations) gives the port's
embedding, its trustworthiness within 0.02 of scikit-learn's (measured:
0.010).
"""
import warnings

import numpy as np
import pytest
import torch

from odin_tpu import ml as jml
from scipy.spatial.distance import squareform
from sklearn.manifold import TSNE as SkTSNE
from sklearn.manifold import trustworthiness as sk_trustworthiness
from sklearn.manifold._t_sne import _joint_probabilities_nn, _kl_divergence
from sklearn.neighbors import NearestNeighbors as SkNN

from odin_tpu_torch import ml as pml
from odin_tpu_torch.ml import tsne as ptsne

torch.set_num_threads(2)
warnings.filterwarnings("ignore", module="sklearn")


def tsne_inputs(n=300, d=10, seed=0):
  rng = np.random.RandomState(seed)
  sizes = (3, 6, 40, 32, 32)
  f = np.stack([rng.randint(0, k, n) for k in sizes], 1)
  mix = rng.rand(5, d) * (rng.rand(5, d) < 0.4)
  mix[np.arange(d) % 5, np.arange(d)] += 1.0
  z = f / (np.array(sizes) - 1.0) @ mix + 0.3 * rng.randn(n, d)
  return z.astype(np.float32)


@pytest.mark.parametrize("n,perplexity", [(300, 30.0), (120, 30.0),
                                          (60, 5.0)])
def test_joint_probabilities_and_gradient_match_sklearn(n, perplexity):
  """At 120 rows scikit-learn searches the 91 neighbours by brute force."""
  z = tsne_inputs(n)
  k = min(n - 1, int(3 * perplexity + 1))
  graph = SkNN(n_neighbors=k).fit(z).kneighbors_graph(mode="distance")
  graph.data **= 2
  want = _joint_probabilities_nn(graph, perplexity, 0).toarray()
  P = ptsne.joint_probabilities_nn(torch.tensor(z), perplexity)
  np.testing.assert_allclose(P.to_dense().numpy(), want, rtol=0, atol=1e-6)
  y = np.random.RandomState(1).randn(n, 2)
  kl, grad = _kl_divergence(y.ravel(), squareform(want, checks=False), 1,
                            n, 2)
  got_kl, got_grad = ptsne.kl_divergence_grad(torch.tensor(y), P)
  np.testing.assert_allclose(got_grad.numpy().ravel(), grad, rtol=0,
                             atol=1e-6 * np.abs(grad).max())
  assert float(got_kl) == pytest.approx(kl, rel=1e-6)


def test_embedding_matches_sklearn_by_kl_and_trustworthiness():
  z = tsne_inputs()
  sk = SkTSNE(n_components=2, random_state=1, perplexity=30.0)
  want = sk.fit_transform(z)
  model = ptsne.TSNE(n_components=2, random_state=1, perplexity=30.0)
  got = model.fit_transform(torch.tensor(z))
  assert model.kl_divergence_ == pytest.approx(sk.kl_divergence_, rel=0.05)
  assert abs(ptsne.trustworthiness(torch.tensor(z), got, 5) -
             sk_trustworthiness(z, want, n_neighbors=5)) <= 0.02
  assert ptsne.trustworthiness(torch.tensor(z), torch.tensor(want), 5) == \
      pytest.approx(sk_trustworthiness(z, want, n_neighbors=5), abs=1e-12)
  assert model.n_iter_ == sk.n_iter_


def test_fast_tsne_as_the_jax_package_calls_it():
  z = tsne_inputs(n=150)
  got = pml.fast_tsne(torch.tensor(z), max_iter=500)
  want = ptsne.TSNE(n_components=2, perplexity=30, random_state=1,
                    max_iter=500).fit_transform(torch.tensor(z))
  np.testing.assert_array_equal(got.numpy(), want.numpy())
  sk = jml.fast_tsne(z, max_iter=500)
  assert abs(ptsne.trustworthiness(torch.tensor(z), got, 5) -
             sk_trustworthiness(z, sk, n_neighbors=5)) <= 0.02
