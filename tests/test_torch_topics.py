"""The port's batch ``LatentDirichletAllocation`` (``odin_tpu_torch/ml/
topics.py``), ``fast_lda_topics`` and ``get_topics_string`` against the
JAX package's (scikit-learn 1.9's model) on the CPU.

Data: the port's ``SyntheticBoW`` (float32 counts, as the JAX package's
``fast_lda_topics`` receives them) and a float64 copy, at 300 documents,
60 words and 4 topics.

Tolerances, of the largest magnitude: float64 1e-9 for ``components_``,
the transform, the bound and the perplexity (the same fixed point with
scikit-learn's digamma, every document stopping at the same iteration;
measured 1e-13).  float32: each document stops when its mean change falls
below 1e-3, and a float32 rounding can move that stop by one iteration and
``components_`` with it; so the port is held to scikit-learn's float64
fit within 1e-5, or twice scikit-learn's own float32 distance from it where
that is larger (measured 8e-7 to 5e-6 for both, seeds 1-3).
"""
import numpy as np
import pytest
import torch

from odin_tpu.ml import fast_lda_topics as jax_topics
from odin_tpu.ml import get_topics_string as jax_topics_string
from odin_tpu_torch.fuel.nlp_data import SyntheticBoW
from odin_tpu_torch.ml import fast_lda_topics, get_topics_string
from odin_tpu_torch.ml.topics import LatentDirichletAllocation, psi
from odin_tpu_torch.weights import from_jax_topics, to_jax_topics

from torch_ml_common import close

CPU = "cpu"
F64_TOL = 1e-9


def _bow(seed=1):
  ds = SyntheticBoW(n_docs=300, n_words=60, n_topics=4, seed=seed)
  return ds._x, ds


def test_fast_lda_topics_float64_matches_jax():
  X, _ = _bow(1)
  X = X.astype(np.float64)
  want = jax_topics(X, n_topics=4)
  got = fast_lda_topics(X, n_topics=4, device=CPU)
  close(got.components_, want.components_, F64_TOL)
  close(got.exp_dirichlet_component_, want.exp_dirichlet_component_,
        F64_TOL)
  close(got.transform(X), want.transform(X), F64_TOL)
  close(got.transform(X, normalize=False),
        want.transform(X, normalize=False), F64_TOL)
  assert abs(got.bound_ - want.bound_) <= F64_TOL * want.bound_
  assert abs(got.score(X) - want.score(X)) <= F64_TOL * abs(want.score(X))
  assert abs(got.perplexity(X) - want.perplexity(X)) <= \
      F64_TOL * want.perplexity(X)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fast_lda_topics_float32(seed):
  X, _ = _bow(seed)
  want32 = jax_topics(X, n_topics=4)
  want64 = jax_topics(X.astype(np.float64), n_topics=4)
  got = fast_lda_topics(X, n_topics=4, device=CPU)
  assert got.components_.dtype == torch.float32
  ref = want64.components_
  scale = np.abs(ref).max()
  own = np.abs(want32.components_ - ref).max() / scale
  apart = np.abs(got.components_.numpy() - ref).max() / scale
  assert apart <= max(1e-5, 2 * own), (apart, own)


def test_get_topics_string_matches_jax():
  X, ds = _bow(2)
  vocab = [f"w{i}" for i in range(X.shape[1])]
  want = jax_topics(X.astype(np.float64), n_topics=4)
  got = fast_lda_topics(X.astype(np.float64), n_topics=4, device=CPU)
  for kw in (dict(), dict(n_topics=2, n_words=5, show_word_prob=True)):
    np.testing.assert_array_equal(get_topics_string(got, vocab, **kw),
                                  jax_topics_string(want, vocab, **kw))


def test_options_and_perplexity_trace():
  X, _ = _bow(3)
  X = X.astype(np.float64)
  from sklearn.decomposition import LatentDirichletAllocation as SkLDA
  kw = dict(doc_topic_prior=0.3, topic_word_prior=0.05, max_iter=6,
            mean_change_tol=1e-4, max_doc_update_iter=30, random_state=4)
  want = SkLDA(n_components=3, **kw).fit(X)
  got = LatentDirichletAllocation(3, device=CPU, evaluate_every=2,
                                  **kw).fit(X)
  close(got.components_, want.components_, F64_TOL)
  assert len(got.perplexities_) == 3
  assert got.perplexities_[-1] < got.perplexities_[0]
  with pytest.raises(NotImplementedError):
    LatentDirichletAllocation(learning_method="online")
  with pytest.raises(ValueError):
    got.transform(-X)


def test_psi_is_scikit_learns():
  from scipy.special import digamma
  x = torch.tensor([1e-7, 1e-3, 0.5, 1.0, 3.7, 6.0, 20.0, 1e4],
                   dtype=torch.float64)
  np.testing.assert_allclose(psi(x).numpy(), digamma(x.numpy()),
                             rtol=1e-8, atol=0)


def test_topics_bridge_round_trip():
  X, _ = _bow(1)
  X = X.astype(np.float64)
  want = jax_topics(X, n_topics=4)
  close(from_jax_topics(want, CPU).transform(X), want.transform(X), 1e-12)
  got = fast_lda_topics(X, n_topics=4, device=CPU)
  back = from_jax_topics(to_jax_topics(got), CPU)
  close(back.transform(X), got.transform(X).numpy(), 0)
  assert back.perplexity(X) == got.perplexity(X)
