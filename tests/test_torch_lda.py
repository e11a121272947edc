"""The port's LDA family (amortizedLDA, nonlinearLDA, ALDA, auxiliaryLDA)
against the JAX package on the CPU: both on the same params
(``to_jax_params``), JAX's Dirichlet draws replayed (the Gamma sampler's
normals and uniforms, in its order), at 24 words, 4 topics and a
16-unit encoder.  The ELBO terms within rtol 1e-5 of each term's largest
magnitude, three Adam steps (``steps_match_jax``), the flax tree of each
class against ``jax.eval_shape`` of its init, and the public surface
(``transform``, ``get_topics``, ``perplexity``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odin_tpu.networks.base import Dense as JaxDense
from odin_tpu.networks.base import SequentialNetwork as JaxSequential
from odin_tpu_torch.networks import Dense, SequentialNetwork
from odin_tpu_torch.training.core import Noise
from torch_zoo_common import (assert_tree_matches_jax_init, elbo_matches_jax,
                              jit_with_draws, make_pair, steps_match_jax,
                              to_torch)

torch.set_num_threads(2)

N_WORDS, N_TOPICS, N_LABELS, B = 24, 4, 3, 8
CLASSES = {
    "amortizedLDA": {},
    "nonlinearLDA": {},
    "ALDA": dict(prior_concentration=0.3),
    "auxiliaryLDA": dict(n_labels=N_LABELS, alpha=5.0),
}


def lda_pair(cls):
  nets = dict(encoder=SequentialNetwork((Dense(16, "relu"),)))
  jnets = dict(encoder=JaxSequential((JaxDense(16, "relu"),),
                                     name="encoder"))
  return make_pair(cls, networks=nets, jax_networks=jnets, n_words=N_WORDS,
                   n_topics=N_TOPICS, **CLASSES[cls])


def counts(seed, n=B):
  rs = np.random.RandomState(seed)
  p = rs.dirichlet(np.full(N_WORDS, 0.2), size=n)
  return np.stack([rs.multinomial(40, q) for q in p]).astype(np.float32)


def batch_of(cls, seed):
  x = counts(seed)
  if cls != "auxiliaryLDA":
    return x
  rs = np.random.RandomState(seed + 100)
  y = rs.randint(0, N_LABELS, size=B).astype(np.int64)
  mask = (np.arange(B) < B // 2).astype(np.float32)
  return x, y, mask


@pytest.fixture(scope="module", params=sorted(CLASSES))
def pair(request):
  return request.param, lda_pair(request.param)


def test_elbo_terms_match_jax(pair):
  cls, p = pair
  elbo_matches_jax(p, batch_of(cls, 1), steps=(0,))


def test_three_adam_steps_match_jax(pair):
  cls, p = pair
  steps_match_jax(p, [batch_of(cls, 10 + i) for i in range(3)])


def test_flax_tree_matches_jax_init(pair):
  """The port's tree (``to_jax_params``) has the paths and shapes of the
  JAX model's own init."""
  cls, (jvae, vae) = pair
  assert_tree_matches_jax_init(jvae, vae, jnp.zeros((1, N_WORDS)))


def test_transform_and_topics_match_jax(pair):
  cls, (jvae, vae) = pair
  x = counts(5, 16)
  np.testing.assert_allclose(vae.transform(x), jvae.transform(x), rtol=1e-5,
                             atol=1e-6)
  np.testing.assert_allclose(vae.transform(x).sum(-1), 1.0, rtol=1e-6)
  idx, probs = vae.get_topics(top_k=5)
  jidx, jprobs = jvae.get_topics(top_k=5)
  np.testing.assert_allclose(probs, jprobs, rtol=1e-5, atol=1e-7)
  assert probs.shape == (N_TOPICS, N_WORDS) and idx.shape == (N_TOPICS, 5)
  # a tie in the sort may order two indices otherwise: compare the values
  np.testing.assert_allclose(np.take_along_axis(probs, idx, -1),
                             np.take_along_axis(jprobs, jidx, -1), rtol=1e-5)


def test_perplexity_is_the_corpus_elbo_per_word(pair):
  """``perplexity`` is ``exp(-sum(elbo) / n_words)`` of the JAX package's
  ELBO on the same draws."""
  cls, (jvae, vae) = pair
  x = counts(6, 16)
  fn = jit_with_draws(lambda p, b, k: jvae.elbo_components(p, b, k, 0)[:2])
  (jl, jk), draws = fn(jvae.state.params, x, jax.random.PRNGKey(0))
  want = float(jnp.exp(-jnp.sum(jvae.elbo(jl, jk)) / np.sum(x)))
  llk, kl, _ = vae.elbo_components(vae.state.params, torch.from_numpy(x),
                                   Noise(eps=to_torch(draws)), 0)
  got = float(torch.exp(-torch.sum(vae.elbo(llk, kl)) / float(np.sum(x))))
  np.testing.assert_allclose(got, want, rtol=1e-5)
  ppl = vae.perplexity(x, seed=3)
  assert np.isfinite(ppl) and ppl > 1.0


def test_labels_head_reads_theta_and_y_may_be_absent():
  _, vae = lda_pair("auxiliaryLDA")
  x, y, mask = batch_of("auxiliaryLDA", 2)
  noise = Noise(torch.Generator().manual_seed(0))
  llk, kl, _ = vae.elbo_components(vae.state.params, torch.from_numpy(x),
                                   noise, 0)
  assert set(llk) == {"llk_docs"} and set(kl) == {"kl_topics"}
  one_hot = np.eye(N_LABELS, dtype=np.float32)[y]
  terms = [vae.elbo_components(vae.state.params, tuple(
      torch.from_numpy(a) for a in (x, yy, mask)), Noise(
          torch.Generator().manual_seed(0)), 0)[0]["llk_labels"]
           for yy in (y, one_hot)]
  torch.testing.assert_close(terms[0], terms[1])
  assert bool((terms[0][B // 2:] == 0).all())
  assert vae.is_semi_supervised()
