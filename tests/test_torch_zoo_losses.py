"""The port's objectives (``bay/vi/losses.py``) against the JAX package's
on the CPU, on the same numpy-seeded posteriors: the maximum mean
discrepancy for each kernel (the prior draws recorded from JAX and
injected), the DIP penalty of types i and ii, the kernels, and
``get_divergence``.  rtol 1e-5 throughout (float32 sums of at most a few
hundred terms)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from odin_tpu.bay import distributions as jax_D
from odin_tpu.bay.vi import losses as jax_losses
from odin_tpu_torch.bay import distributions as D
from odin_tpu_torch.bay.vi import losses
from odin_tpu_torch.training.core import Noise
from torch_zoo_common import jit_with_draws, to_torch

torch.set_num_threads(2)

RTOL = 1e-5


def _posterior(n=12, d=5, seed=0):
  rs = np.random.RandomState(seed)
  loc = rs.randn(n, d).astype(np.float32)
  scale = np.exp(0.3 * rs.randn(n, d)).astype(np.float32)
  return loc, scale


def _both(loc, scale):
  return (jax_D.MultivariateNormalDiag(jnp.asarray(loc), jnp.asarray(scale)),
          D.MultivariateNormalDiag(torch.from_numpy(loc),
                                   torch.from_numpy(scale)))


@pytest.mark.parametrize("kernel,q_given", [
    ("gaussian", True), ("linear", True), ("polynomial", True),
    ("gaussian", False)])
def test_mmd_matches_jax(kernel, q_given):
  loc, scale = _posterior()
  jq, q = _both(loc, scale)
  d = loc.shape[-1]
  jp, p = _both(np.zeros((d,), np.float32), np.ones((d,), np.float32))
  zq = (loc + scale * np.random.RandomState(3).randn(*loc.shape)).astype(
      np.float32)
  fn = jit_with_draws(lambda key: jax_losses.maximum_mean_discrepancy(
      jq, jp, key, p_sample_shape=30, kernel=kernel,
      q_samples=jnp.asarray(zq) if q_given else None))
  want, draws = fn(jax.random.PRNGKey(5))
  assert len(draws) == (1 if q_given else 2)
  got = losses.maximum_mean_discrepancy(
      q, p, Noise(eps=to_torch(draws)), p_sample_shape=30, kernel=kernel,
      q_samples=torch.from_numpy(zq) if q_given else None)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                             atol=RTOL * 1e-2)


@pytest.mark.parametrize("only_mean", [True, False])
@pytest.mark.parametrize("lambdas", [(2.0, 1.0), (10.0, 5.0)])
def test_dip_matches_jax(only_mean, lambdas):
  loc, scale = _posterior(n=32, d=6, seed=1)
  jq, q = _both(loc, scale)
  off, diag = lambdas
  want = jax_losses.disentangled_inferred_prior_loss(
      jq, only_mean=only_mean, lambda_offdiag=off, lambda_diag=diag)
  got = losses.disentangled_inferred_prior_loss(
      q, only_mean=only_mean, lambda_offdiag=off, lambda_diag=diag)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("name,kwargs", [
    ("gaussian_kernel", {}), ("gaussian_kernel", dict(sigma=0.7)),
    ("linear_kernel", {}), ("polynomial_kernel", {}),
    ("polynomial_kernel", dict(degree=3, gamma=0.5, coef0=0.2)),
    ("pairwise_distances", {})])
def test_kernels_match_jax(name, kwargs):
  rs = np.random.RandomState(2)
  x = rs.randn(7, 4).astype(np.float32)
  y = rs.randn(9, 4).astype(np.float32)
  want = getattr(jax_losses, name)(jnp.asarray(x), jnp.asarray(y), **kwargs)
  got = getattr(losses, name)(torch.from_numpy(x), torch.from_numpy(y),
                              **kwargs)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                             atol=1e-6)


@pytest.mark.parametrize("name", ["dip", "tc", "mmd", "kl", " MMD "])
def test_get_divergence_names_the_same_function(name):
  got = losses.get_divergence(name)
  want = jax_losses.get_divergence(name)
  assert got.__name__ == want.__name__


def test_get_divergence_rejects_unknown_names():
  with pytest.raises(ValueError, match="dip, tc, mmd, kl"):
    losses.get_divergence("wasserstein")


def test_get_divergence_computes_as_jax():
  loc, scale = _posterior(n=16, d=4, seed=4)
  jq, q = _both(loc, scale)
  np.testing.assert_allclose(
      losses.get_divergence("dip")(q).numpy(),
      np.asarray(jax_losses.get_divergence("dip")(jq)), rtol=RTOL)
  z = (loc + scale).astype(np.float32)
  np.testing.assert_allclose(
      losses.get_divergence("tc")(torch.from_numpy(z), q).numpy(),
      np.asarray(jax_losses.get_divergence("tc")(jnp.asarray(z), jq)),
      rtol=RTOL, atol=RTOL)
