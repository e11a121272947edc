"""The port's ``explain`` (``odin_tpu_torch/explain``) against the JAX
package's ``odin_tpu/explain`` on the CPU, on a half-moons BetaVAE whose
params both packages share (the JAX model's state is the port's params
carried across) and with JAX's ELBO noise injected into the port
(``AdversarialAttack(eps=...)``; JAX draws it from ``PRNGKey(0)``, recorded
by ``torch_zoo_common.jit_with_draws``).

Tolerances: FGSM's and PGD's inputs equal JAX's except where the loss's
gradient is under 1e-6 of its largest (where its sign is the two
packages' float32 rounding); the input gradients within 1e-5 of the
largest; DeepDream after 50 steps within 1e-4 of the largest value.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odin_tpu.bay.vi as jax_vi
import odin_tpu.explain as jax_explain
from odin_tpu.networks import get_networks as jax_get_networks
from odin_tpu.training.core import TrainState as JaxTrainState
import odin_tpu_torch.explain as explain
from odin_tpu_torch.bay.vi import BetaVAE
from odin_tpu_torch.explain import (AdversarialAttack, DeepDream,
                                    fgsm_attack, pgd_attack)
from odin_tpu_torch.networks import get_networks
from odin_tpu_torch.weights import to_jax_params
from torch_zoo_common import jit_with_draws

X = np.random.RandomState(0).rand(32, 2).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
  vae = BetaVAE(**get_networks("halfmoons", zdim=2)).build(seed=3,
                                                           device="cpu")
  jvae = jax_vi.BetaVAE(**jax_get_networks("halfmoons", zdim=2))
  jvae.input_shape = (2,)
  jvae.state = JaxTrainState(
      params={"vae": to_jax_params(vae.core)}, opt_states={},
      step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(4),
      mutables={})
  return jvae, vae


def test_explain_all_equals_jax():
  assert explain.__all__ == jax_explain.__all__


def _jax_eps(jvae):
  """The ELBO noise of JAX's ``AdversarialAttack._loss`` on X."""
  att = jax_explain.AdversarialAttack(jvae)
  (_, draws) = jit_with_draws(att._loss)(jnp.asarray(X))
  assert len(draws) == 1
  return np.array(draws[0])


def _agree_where_gradient_counts(got, want, grad):
  small = np.abs(grad) < 1e-6 * np.abs(grad).max()
  np.testing.assert_array_equal(got[~small], want[~small])


def test_loss_and_gradient_match_jax(pair):
  jvae, vae = pair
  eps = _jax_eps(jvae)
  jatt = jax_explain.AdversarialAttack(jvae)
  att = AdversarialAttack(vae, eps=torch.from_numpy(eps))
  x = torch.from_numpy(X)
  assert float(att._loss(x)) == pytest.approx(
      float(jatt._loss(jnp.asarray(X))), abs=1e-5)
  g = explain._grad(att._loss, x).numpy()
  jg = np.asarray(jax.grad(jatt._loss)(jnp.asarray(X)))
  np.testing.assert_allclose(g, jg, atol=1e-5 * np.abs(jg).max())


@pytest.mark.parametrize("method", ["fgsm", "pgd"])
def test_adversarial_attack_matches_jax(pair, method):
  jvae, vae = pair
  eps = _jax_eps(jvae)
  jatt = jax_explain.AdversarialAttack(jvae, epsilon=0.05, method=method,
                                       n_steps=5)
  att = AdversarialAttack(vae, epsilon=0.05, method=method, n_steps=5,
                          eps=torch.from_numpy(eps))
  want = jatt.attack(jnp.asarray(X))
  got = att.attack(X).numpy()
  assert got.shape == want.shape and got.dtype == np.float32
  jg = np.asarray(jax.grad(jatt._loss)(jnp.asarray(X)))
  _agree_where_gradient_counts(got, want, jg)
  assert np.abs(got - X).max() <= 0.05 + 1e-6
  assert got.min() >= 0.0 and got.max() <= 1.0


def test_attack_draws_from_a_seeded_generator(pair):
  """Without `eps` each loss draws from a generator seeded `seed`: the
  same draw every step, and another seed gives another loss."""
  _, vae = pair
  x = torch.from_numpy(X)
  a, b = AdversarialAttack(vae, seed=1), AdversarialAttack(vae, seed=2)
  assert float(a._loss(x)) == float(a._loss(x))
  assert float(a._loss(x)) != float(b._loss(x))


def test_fgsm_and_pgd_functions_match_jax():
  """A quadratic loss: the functions against JAX's on the same inputs."""
  rs = np.random.RandomState(1)
  x = rs.rand(4, 6).astype(np.float32)
  w = rs.randn(6, 3).astype(np.float32)
  jloss = lambda v: jnp.sum(jnp.square(v @ w - 1.0))
  tw = torch.from_numpy(w)
  tloss = lambda v: torch.sum(torch.square(v @ tw - 1.0))
  jg = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
  _agree_where_gradient_counts(
      fgsm_attack(tloss, torch.from_numpy(x), 0.1).numpy(),
      np.asarray(jax_explain.fgsm_attack(jloss, x, 0.1)), jg)
  got = pgd_attack(tloss, torch.from_numpy(x), 0.1, 0.03, 6).numpy()
  want = np.asarray(jax_explain.pgd_attack(jloss, x, 0.1, 0.03, 6))
  np.testing.assert_allclose(got, want, atol=1e-6)


def test_deep_dream_matches_jax(pair):
  """50 steps on the encoder's posterior mean as the features."""
  jvae, vae = pair
  params = jvae._params_of()
  rng = jax.random.PRNGKey(0)
  jfeat = lambda x: jvae._apply(params, "encode", x, rng=rng).mean()
  feat = lambda x: vae.encode(x).mean()
  want = jax_explain.DeepDream(jfeat, step_size=0.01, n_steps=50).dream(
      jnp.asarray(X))
  got = DeepDream(feat, step_size=0.01, n_steps=50).dream(
      torch.from_numpy(X)).numpy()
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
