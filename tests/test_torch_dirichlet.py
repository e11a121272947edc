"""The port's Dirichlet against the JAX package's on the CPU: the
densities and moments, the KL between two Dirichlets, the sample from
JAX's own Gamma draws (eight Marsaglia-Tsang rounds of a normal and a
uniform, then the boost's uniform, replayed in that order) and its
pathwise gradient with respect to the concentration, all at rtol 1e-5;
the ``'dirichlet'`` alias; and the two inputs on which the packages part
on purpose (ROADMAP.md queue 3): concentrations small enough that JAX's
boosted Gammas underflow, and rows whose eight proposals all reject."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odin_tpu.bay.distribution_alias import parse_distribution as jax_alias
from odin_tpu.bay.distributions.continuous import Dirichlet as JaxDirichlet
from odin_tpu.bay.helpers import kl_divergence as jax_kl
from odin_tpu_torch.bay.distribution_alias import parse_distribution
from odin_tpu_torch.bay.distributions import Dirichlet
from odin_tpu_torch.bay.distributions.sampling import (GAMMA_ROUNDS,
                                                       check_rejections,
                                                       log_gamma_pathwise,
                                                       rejection_stats,
                                                       reset_rejection_stats)
from odin_tpu_torch.bay.helpers import kl_divergence
from odin_tpu_torch.training.core import Noise
from torch_zoo_common import jit_with_draws, to_torch

torch.set_num_threads(2)


def concentration(seed, shape=(6, 5), low=0.2):
  """Concentrations from `low` to about 20, below and above 1."""
  rs = np.random.RandomState(seed)
  return (low + np.exp(rs.randn(*shape) * 1.2)).astype(np.float32)


def both(a):
  return Dirichlet(torch.from_numpy(a)), JaxDirichlet(jnp.asarray(a))


def close(got, want, rtol=1e-5, atol=0.0):
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=rtol, atol=atol)


def test_shapes_and_moments_match_jax():
  d, j = both(concentration(0, (3, 4, 5), low=1.1))
  assert tuple(d.batch_shape) == j.batch_shape == (3, 4)
  assert tuple(d.event_shape) == j.event_shape == (5,)
  for name in ("mean", "mode", "variance", "entropy"):
    close(getattr(d, name)(), getattr(j, name)(), atol=1e-6)


def test_log_prob_matches_jax():
  a = concentration(1)
  d, j = both(a)
  x = np.random.RandomState(2).dirichlet(np.ones(5), size=6).astype(
      np.float32)
  close(d.log_prob(torch.from_numpy(x)), j.log_prob(jnp.asarray(x)),
        atol=1e-5)


def test_kl_matches_jax():
  q, jq = both(concentration(3))
  p, jp = both(concentration(4))
  close(kl_divergence(q, p, analytic=True),
        jax_kl(jq, jp, analytic=True), atol=1e-5)
  close(kl_divergence(q, p, analytic=True), torch.distributions.kl_divergence(
      torch.distributions.Dirichlet(q.concentration),
      torch.distributions.Dirichlet(p.concentration)), atol=1e-5)


@pytest.mark.parametrize("sample_shape", [(), (3,)])
def test_sample_from_jax_draws_matches_jax(sample_shape):
  a = concentration(5)
  fn = jit_with_draws(lambda c, k: JaxDirichlet(c).sample(k, sample_shape))
  want, draws = fn(jnp.asarray(a), jax.random.PRNGKey(7))
  shape = tuple(sample_shape) + a.shape
  assert [tuple(d.shape) for d in draws] == [shape] * (2 * GAMMA_ROUNDS + 1)
  got = Dirichlet(torch.from_numpy(a)).sample_from(Noise(eps=to_torch(draws)),
                                                   sample_shape)
  close(got, want, atol=1e-7)
  torch.testing.assert_close(got.sum(-1), torch.ones(shape[:-1]))


def test_pathwise_gradient_matches_jax():
  """d/d alpha of a weighted sum of the sample, the accepted proposal
  held: JAX's autodiff through ``_sample_gamma`` against the port's
  through ``log_gamma_pathwise``."""
  a = concentration(8, (16, 4))
  w = np.random.RandomState(9).randn(16, 4).astype(np.float32)
  key = jax.random.PRNGKey(11)
  _, draws = jit_with_draws(lambda c, k: JaxDirichlet(c).sample(k))(
      jnp.asarray(a), key)
  want = jax.jit(jax.grad(lambda c: jnp.sum(JaxDirichlet(c).sample(key) *
                                            w)))(jnp.asarray(a))
  alpha = torch.from_numpy(a).requires_grad_()
  theta = Dirichlet(alpha).sample_from(Noise(eps=to_torch(draws)))
  (theta * torch.from_numpy(w)).sum().backward()
  close(alpha.grad, want, atol=1e-6)
  assert float(alpha.grad.abs().max()) > 1e-2


def test_alias_and_prior_match_jax():
  spec, jspec = parse_distribution("dirichlet"), jax_alias("dirichlet")
  assert spec.params_size(6) == jspec.params_size(6) == 6
  raw = np.random.RandomState(1).randn(4, 6).astype(np.float32)
  close(spec.builder(torch.from_numpy(raw), (6,)).concentration,
        jspec.builder(jnp.asarray(raw), (6,)).concentration)
  prior = spec.default_prior((6,))
  assert isinstance(prior, Dirichlet)
  torch.testing.assert_close(prior.concentration, torch.ones(6))


def test_small_concentrations_stay_on_the_simplex():
  """Where alpha is small, ``u^(1/alpha)`` leaves float32's normal range:
  JAX's Gammas go subnormal or to 0, so its rows hold exact zeros,
  values rounded at subnormal precision, or NaN where every component
  underflowed, and its Monte-Carlo KL is not finite.  The port forms the
  sample from the log Gammas: every row sums to 1, no component is below
  the smallest subnormal, the KL is finite, and each row matches the same
  computation in float64 (rtol 1e-4: float32 logs near -100 carry 1e-5).
  Where all of a row's Gammas are normal floats, the port's row is JAX's
  (rtol 1e-5)."""
  a = np.full((1024, 3), 0.01, np.float32)
  fn = jit_with_draws(lambda c, k: JaxDirichlet(c).sample(k))
  want, draws = fn(jnp.asarray(a), jax.random.PRNGKey(0))
  want = np.asarray(want)
  got = Dirichlet(torch.from_numpy(a)).sample_from(Noise(eps=to_torch(draws)))
  d = [torch.from_numpy(np.array(v)) for v in draws]
  x, u = torch.stack(d[0:-1:2]), torch.stack(d[1:-1:2])
  log_g = log_gamma_pathwise(torch.from_numpy(a), x, u, d[-1])
  normal = (log_g > np.log(np.finfo(np.float32).tiny)).all(-1).numpy()
  assert 10 < (~normal).sum() and (~np.isfinite(want).all(-1)).sum() > 10
  assert (want[~normal] == 0).any()
  np.testing.assert_allclose(got.numpy()[normal], want[normal], rtol=1e-5,
                             atol=1e-7)
  log_g64 = log_gamma_pathwise(torch.from_numpy(a).double(), x.double(),
                               u.double(), d[-1].double())
  want64 = torch.softmax(log_g64, -1).numpy()
  big = want64 > 1e-30
  np.testing.assert_allclose(got.numpy()[big], want64[big], rtol=1e-4)
  assert bool((got > 0).all())
  torch.testing.assert_close(got.sum(-1), torch.ones(1024))
  prior = Dirichlet(torch.full((3,), 0.7))
  kl = kl_divergence(Dirichlet(torch.from_numpy(a)), prior, q_sample=got)
  assert bool(torch.isfinite(kl).all())
  jkl = jax_kl(JaxDirichlet(jnp.asarray(a)), JaxDirichlet(jnp.full((3,), 0.7)),
               q_sample=jnp.asarray(want))
  assert not np.isfinite(np.asarray(jkl)).all()


def test_rows_that_never_accept_fall_back_as_in_jax():
  """A row whose eight proposals all reject (every normal below -1/c, so
  ``(1 + c x)^3 <= 0``) takes JAX's fallback, ``d`` times the boost, in
  both packages; the port counts it (kind 'dirichlet') and does not
  raise, unlike its other samplers' misses."""
  a = np.asarray([[0.5, 2.0, 4.0], [1.5, 1.5, 1.5]], np.float32)
  shape = a.shape
  x = np.full(shape, -50.0, np.float32)
  u = np.full(shape, 0.5, np.float32)
  draws = [x, u] * GAMMA_ROUNDS + [np.full(shape, 0.25, np.float32)]
  boosted = np.where(a < 1, a + 1, a)
  g = (boosted - 1 / 3) * np.where(a < 1, 0.25 ** (1 / a), 1.0)
  want = g / g.sum(-1, keepdims=True)
  reset_rejection_stats()
  got = Dirichlet(torch.from_numpy(a)).sample_from(Noise(eps=[
      torch.from_numpy(d) for d in draws]))
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
  orig = jax.random.normal, jax.random.uniform
  it = iter(draws)
  try:  # the same draws through JAX's sampler
    jax.random.normal = lambda *args, **kw: jnp.asarray(next(it))
    jax.random.uniform = lambda *args, **kw: jnp.asarray(next(it))
    jwant = JaxDirichlet(jnp.asarray(a)).sample(jax.random.PRNGKey(0))
  finally:
    jax.random.normal, jax.random.uniform = orig
  np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=1e-6)
  stats = rejection_stats()["dirichlet@cpu"]
  assert stats["failed"] == a.size and stats["accepted"] == 0
  check_rejections()  # no raise: the value is JAX's


def test_generator_samples_lie_on_the_simplex():
  d = Dirichlet(torch.from_numpy(concentration(12, (1000, 4))))
  theta = d.sample((2,), generator=torch.Generator().manual_seed(0))
  assert theta.shape == (2, 1000, 4)
  torch.testing.assert_close(theta.sum(-1), torch.ones(2, 1000))
  mean = d.sample((64,), generator=torch.Generator().manual_seed(1)).mean(0)
  assert float((mean - d.mean()).abs().mean()) < 0.02
