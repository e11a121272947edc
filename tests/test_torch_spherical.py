"""The port's spherical distributions (``bay/distributions/spherical.py``)
against the JAX package's on the CPU.

  * ``log_prob``, ``entropy``, ``mean`` and the KL to the uniform of vMF
    and PowerSpherical at d in {3, 10, 64} and kappa from 0.1 to 500,
    rtol 1e-5, atol 1e-5 where a value is near 0, plus 1e-7 (about one
    float32 ulp) of the largest log-Gamma term where PowerSpherical's
    log-normalizer (in log_prob, entropy and KL) is a difference of such
    terms (2,600 at kappa 500);
    their gradients through kappa and mu, rtol 1e-4 (atol 1e-5)
    (tests/test_torch_spherical_law.py).
  * ``_log_iv_bessel`` against ``scipy.special.ive``: the power series
    (kappa < 20) at 1e-6 relative, in float64, where the series is the
    only error; above 20 the JAX package's leading asymptotic term is
    carried as it is, whose own truncation error (Abramowitz & Stegun
    9.7.7 without its correction terms) is up to 4e-3 relative at d = 64:
    that branch is held to JAX at 1e-6 (atol 1e-5: in float32 its terms
    cancel) and to scipy within 5e-3.
  * PowerSpherical samples against JAX's, with JAX's log-Gamma and normal
    draws injected, rtol 1e-5 (atol 1e-6).
  * vMF cosines ``w`` drawn by the port's fixed-proposal Wood sampler: their
    mean within 3 standard errors of the closed form A_d(kappa), and their
    law against JAX's while-loop sampler by a two-sample KS test at
    p > 0.01; no row goes unaccepted (tests/test_torch_spherical_law.py).
"""
import numpy as np
import pytest
import torch
from scipy import special, stats

import jax
import jax.numpy as jnp

from odin_tpu.bay.distributions import spherical as jax_sph
from odin_tpu_torch.bay.distributions import sampling, spherical as sph
from odin_tpu_torch.bay.helpers import kl_divergence
from odin_tpu_torch.training.core import Noise
from odin_tpu.bay.helpers import kl_divergence as jax_kl
from torch_zoo_common import jit_with_draws, to_torch

torch.set_num_threads(2)

DIMS = (3, 10, 64)
KAPPAS = np.geomspace(0.1, 500.0, 12).astype(np.float32)


def _params(d, seed=0):
  rs = np.random.RandomState(seed + d)
  mu = rs.randn(len(KAPPAS), d).astype(np.float32)
  mu /= np.linalg.norm(mu, axis=-1, keepdims=True)
  x = rs.randn(len(KAPPAS), d).astype(np.float32)
  x /= np.linalg.norm(x, axis=-1, keepdims=True)
  return mu, x


def _quantities(D, kl, mu, kappa, x, d):
  q = D(mu, kappa)
  u = (jax_sph.SphericalUniform(d) if D.__module__.startswith("odin_tpu.")
       else sph.SphericalUniform(d))
  return dict(log_prob=q.log_prob(x), entropy=q.entropy(), mean=q.mean(),
              kl=kl(q, u, analytic=True))


@pytest.mark.parametrize("family", ["VonMisesFisher", "PowerSpherical"])
@pytest.mark.parametrize("d", DIMS)
def test_density_entropy_mean_kl_match_jax(family, d):
  mu, x = _params(d)
  want = _quantities(getattr(jax_sph, family), jax_kl, jnp.asarray(mu),
                     jnp.asarray(KAPPAS), jnp.asarray(x), d)
  got = _quantities(getattr(sph, family), kl_divergence, torch.from_numpy(mu),
                    torch.from_numpy(KAPPAS), torch.from_numpy(x), d)
  alpha = (d - 1.0) / 2.0 + KAPPAS.astype(np.float64)
  term = np.abs(special.gammaln(alpha + (d - 1.0) / 2.0)).max()
  for name in want:
    atol = 1e-5 + (1e-7 * term if family == "PowerSpherical" and
                   name != "mean" else 0.0)
    np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                               rtol=1e-5, atol=atol, err_msg=name)


@pytest.mark.parametrize("d", (2, 3, 10, 64))
def test_log_bessel_series_matches_scipy(d):
  nu = d / 2.0 - 1.0
  k = np.geomspace(0.1, 19.99, 200)
  got = sph._log_iv_bessel(nu, torch.from_numpy(k)).numpy()
  want = np.log(special.ive(nu, k)) + k
  np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("d", (2, 3, 10, 64))
def test_log_bessel_asymptotic_branch_matches_jax_and_scipy(d):
  nu = d / 2.0 - 1.0
  k = np.geomspace(20.0, 500.0, 200).astype(np.float32)
  got = sph._log_iv_bessel(nu, torch.from_numpy(k)).numpy()
  np.testing.assert_allclose(
      got, np.asarray(jax_sph._log_iv_bessel(nu, jnp.asarray(k))), rtol=1e-6,
      atol=1e-5)
  want = np.log(special.ive(nu, k.astype(np.float64))) + k
  np.testing.assert_allclose(got, want, rtol=5e-3)


def test_log_bessel_gradient_is_finite_across_the_switch():
  k = torch.tensor([19.5, 19.999, 20.0, 20.001, 400.0], dtype=torch.float64,
                   requires_grad=True)
  sph._log_iv_bessel(4.0, k).sum().backward()
  assert torch.isfinite(k.grad).all()
  # d/dk log I_nu(k) = I_{nu+1}(k) / I_nu(k) + nu / k
  kk = k.detach().numpy()
  want = special.ive(5.0, kk) / special.ive(4.0, kk) + 4.0 / kk
  np.testing.assert_allclose(k.grad.numpy()[:2], want[:2], rtol=1e-6)


@pytest.mark.parametrize("d,sample_shape", [(3, ()), (64, (3,))])
def test_power_spherical_samples_match_jax_with_its_draws(d, sample_shape):
  mu, _ = _params(d, seed=2)
  jq = jax_sph.PowerSpherical(jnp.asarray(mu), jnp.asarray(KAPPAS))
  want, draws = jit_with_draws(lambda key: jq.sample(key, sample_shape))(
      jax.random.PRNGKey(d))
  assert len(draws) == 3  # the two log-Gammas of the Beta, the normals
  q = sph.PowerSpherical(torch.from_numpy(mu), torch.from_numpy(KAPPAS))
  got = q.sample_from(Noise(eps=to_torch(draws)), sample_shape)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-6)
  np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                             rtol=1e-5)


def test_vmf_sample_is_on_the_sphere_and_counts_its_proposals():
  sampling.reset_rejection_stats()
  mu = torch.nn.functional.normalize(torch.randn(5, 10), dim=-1)
  q = sph.VonMisesFisher(mu, torch.linspace(1.0, 50.0, 5))
  z = q.sample((7,), generator=torch.Generator().manual_seed(0))
  assert z.shape == (7, 5, 10)
  np.testing.assert_allclose(torch.linalg.vector_norm(z, dim=-1).numpy(), 1.0,
                             rtol=1e-5)
  s = sampling.rejection_stats()["vmf@cpu"]
  assert s["rows"] == 35 and s["proposals"] == 35 * sph.VMF_PROPOSALS
  assert 0 < s["accepted"] <= s["proposals"] and s["failed"] == 0


def test_a_row_no_proposal_accepts_is_nan_and_raises(monkeypatch):
  """No draw is silently kept: with every proposal rejected the cosine is
  NaN, the row is counted, and the next check raises, once."""
  sampling.reset_rejection_stats()
  # uniforms of 1: log(u) = 0 is above every vMF acceptance bound
  monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.ones(
      a[0], dtype=k.get("dtype")))
  q = sph.VonMisesFisher(torch.tensor([[1.0, 0.0, 0.0]]), torch.tensor([5.0]))
  try:
    w = q._sample_w(torch.Generator().manual_seed(0), (1,))
    assert torch.isnan(w).all()
    assert sampling.rejection_stats()["vmf@cpu"]["failed"] == 1
    raised = []
    for _ in range(3):  # one raise for each kind that failed (vMF, Gamma)
      try:
        sampling.check_rejections()
      except RuntimeError as e:
        raised.append(str(e))
    assert any(m.startswith("1 vmf draws") for m in raised), raised
    sampling.check_rejections()  # each row reported once
    with pytest.raises(RuntimeError, match="no accepted proposal"):
      q.sample(generator=torch.Generator().manual_seed(0))
  finally:
    sampling.reset_rejection_stats()
