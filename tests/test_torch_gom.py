"""The port's GradeMembershipModel against the JAX package on the CPU:
12 questions of 5 answers, 3 profiles, the (8, 8) encoder; both on the
same params (the stacked ``enc_w*``/``enc_b*``, ``conc_*`` and
``profile_logits`` carried by ``to_jax_params``), JAX's Dirichlet draws
replayed.  The ELBO terms before, inside and after the KL warm-up, three
Adam steps, the flax tree against the JAX init, and ``predict``,
``transform`` and ``get_profiles``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odin_tpu.bay.mixed_membership import GradeMembershipModel as JaxGoM
from odin_tpu_torch.bay.mixed_membership import GradeMembershipModel
from torch_zoo_common import (assert_tree_matches_jax_init, elbo_matches_jax,
                              jax_state_of, steps_match_jax)

torch.set_num_threads(2)

Q, A, K, B = 12, 5, 3, 8
KW = dict(n_questions=Q, n_answers=A, n_components=K, encoder_layers=(8, 8))


def sheets(seed, n=B):
  """Answer sheets of the example's planted profiles with 10 % noise."""
  rs = np.random.RandomState(seed)
  profiles = (2 * np.arange(K)[:, None] + np.arange(Q)[None, :]) % A
  answers = profiles[rs.randint(0, K, size=n)]
  noisy = rs.rand(n, Q) < 0.1
  return np.where(noisy, rs.randint(0, A, size=answers.shape),
                  answers).astype(np.float32)


@pytest.fixture(scope="module", params=[0, 50])
def pair(request):
  kw = dict(KW, warmup_steps=request.param)
  vae = GradeMembershipModel(**kw).build(seed=1, device="cpu")
  jvae = JaxGoM(**kw)
  jvae.input_shape = vae.input_shape
  jvae.state = jax_state_of(vae)
  return jvae, vae


def test_elbo_terms_match_jax(pair):
  """``kl_profiles`` is a mean over the questions of ``log q(theta) - log
  p(theta)``, log-densities of up to about 3 here that nearly cancel at
  the initial params (a KL of 1e-3): it is held to rtol 1e-5 of 1, their
  scale (JAX's float32 sum of log-Gammas is 2.7e-6 from the float64 value
  there, the port's 1e-7: ``test_kl_is_the_float64_value``)."""
  elbo_matches_jax(pair, sheets(1), steps=(0, 20, 700),
                   scales={"kl_profiles": 1.0})


def test_kl_is_the_float64_value(pair):
  """The port's KL term on its own draws against the same sum in float64:
  within 1e-6."""
  _, vae = pair
  from odin_tpu_torch.bay.distributions import Dirichlet
  from odin_tpu_torch.training.core import Noise
  x = torch.from_numpy(sheets(1))
  _, kl, aux = vae.elbo_components(vae.state.params, x, Noise(
      torch.Generator().manual_seed(4)), 0)
  q, theta = aux["qz"], aux["z"].double()
  prior = Dirichlet(torch.full((K,), 0.7, dtype=torch.float64))
  want = (Dirichlet(q.concentration.double()).log_prob(theta) -
          prior.log_prob(theta)).mean(-1)
  torch.testing.assert_close(kl["kl_profiles"].double(), want, rtol=0,
                             atol=1e-6)


def test_three_adam_steps_match_jax(pair):
  steps_match_jax(pair, [sheets(10 + i) for i in range(3)],
                  scales={"kl_profiles": 1.0})


def test_flax_tree_matches_jax_init(pair):
  assert_tree_matches_jax_init(*pair, jnp.zeros((1, Q)))


def test_predict_transform_profiles_match_jax(pair):
  jvae, vae = pair
  x = sheets(7, 32)
  np.testing.assert_array_equal(vae.predict(x), jvae.predict(x))
  for per_question in (False, True):
    np.testing.assert_allclose(
        vae.transform(x, per_question=per_question),
        jvae.transform(x, per_question=per_question), rtol=1e-5, atol=1e-7)
  np.testing.assert_allclose(vae.get_profiles(), jvae.get_profiles(),
                             rtol=1e-6, atol=1e-7)
  assert vae.transform(x).shape == (32, K)
  np.testing.assert_allclose(vae.transform(x).sum(-1), 1.0, rtol=1e-6)


def test_warmup_scales_the_kl_in_training_only():
  vae = GradeMembershipModel(**KW, warmup_steps=100).build(seed=1,
                                                           device="cpu")
  from odin_tpu_torch.training.core import Noise
  x = torch.from_numpy(sheets(3))
  kls = {}
  for step, training in ((0, True), (50, True), (100, True), (50, False)):
    _, kl, _ = vae.elbo_components(
        vae.state.params, x, Noise(torch.Generator().manual_seed(0)),
        torch.tensor(step), training=training)
    kls[(step, training)] = kl["kl_profiles"]
  assert bool((kls[(0, True)] == 0).all())
  torch.testing.assert_close(kls[(50, True)], 0.5 * kls[(100, True)])
  torch.testing.assert_close(kls[(50, False)], kls[(100, True)])
