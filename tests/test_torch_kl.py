"""The port's KL divergence, annealing schedules and ELBO estimators against
the JAX package on the CPU.

Both packages get the same seeded numpy inputs and, for Monte-Carlo KLs,
the same samples.  Limits: 1e-5 (rtol and atol) on KLs, float32 sums of 10
log densities taken in another order; 1e-6 on the schedules, elementwise
float32 curves whose transcendentals come from two libraries.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from odin_tpu.backend import interpolation as jinterp
from odin_tpu.bay import distributions as jd
from odin_tpu.bay.helpers import kl_divergence as jax_kl
from odin_tpu.bay.vi._base import VariationalModel as JaxVariationalModel
from odin_tpu_torch.backend import interpolation as tinterp
from odin_tpu_torch.bay import distributions as td
from odin_tpu_torch.bay.helpers import kl_divergence
from odin_tpu_torch.bay.vi._base import VariationalModel

KL_TOL = 1e-5
SCHEDULE_TOL = 1e-6


def _np(t):
  return t.detach().cpu().numpy()


def _pair(family, seed=0):
  rs = np.random.RandomState(seed)
  loc = rs.randn(2, 5, 10).astype(np.float32)
  scale = (np.exp(0.3 * rs.randn(2, 5, 10)) + 0.1).astype(np.float32)
  t = torch.from_numpy
  if family == "mvndiag":
    return ((jd.MultivariateNormalDiag(loc[0], scale[0]),
             jd.MultivariateNormalDiag(loc[1], scale[1])),
            (td.MultivariateNormalDiag(t(loc[0]), t(scale[0])),
             td.MultivariateNormalDiag(t(loc[1]), t(scale[1]))))
  return ((jd.Independent(jd.Normal(loc[0], scale[0]), 1),
           jd.Independent(jd.Normal(loc[1], scale[1]), 1)),
          (td.Independent(td.Normal(t(loc[0]), t(scale[0])), 1),
           td.Independent(td.Normal(t(loc[1]), t(scale[1])), 1)))


@pytest.mark.parametrize("family", ["mvndiag", "normal"])
@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("analytic", [True, False])
@pytest.mark.parametrize("free_bits", [None, 0.5])
@pytest.mark.parametrize("sample_shape", [(), (3,), (2, 3)])
def test_kl_divergence_matches_jax(family, reverse, analytic, free_bits,
                                   sample_shape):
  (jq, jp), (q, p) = _pair(family)
  z = np.random.RandomState(1).randn(*sample_shape, 5, 10).astype(np.float32)
  want = np.asarray(jax_kl(jq, jp, analytic=analytic, q_sample=z,
                           reverse=reverse, free_bits=free_bits))
  got = _np(kl_divergence(q, p, analytic=analytic,
                          q_sample=torch.from_numpy(z), reverse=reverse,
                          free_bits=free_bits))
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, rtol=KL_TOL, atol=KL_TOL)


def test_kl_divergence_draws_from_a_generator():
  """An int q_sample draws that many samples; the estimate averages them
  over its leading axis, and the draw is the generator's."""
  _, (q, p) = _pair("mvndiag")
  got = kl_divergence(q, p, q_sample=4,
                      generator=torch.Generator().manual_seed(3))
  z = q.sample((4,), generator=torch.Generator().manual_seed(3))
  want = torch.mean(q.log_prob(z) - p.log_prob(z), dim=0)
  assert tuple(got.shape) == (5,)
  torch.testing.assert_close(got, want, rtol=0, atol=0)
  with pytest.raises(ValueError):
    kl_divergence(q, p)


SCHEDULES = [
    ("const", dict(vmin=0.2, vmax=3.)),
    ("linear", dict(vmin=0.5, vmax=2., steps=40)),
    ("linear", dict(vmin=0., vmax=1., steps=10, delay_in=5, delay_out=3,
                    cyclical=True)),
    ("smooth", dict(steps=30)), ("smooth2", dict(steps=30)),
    ("fade", dict(steps=30)), ("smoother", dict(steps=30, delay_in=4)),
    ("power", dict(steps=30, power=3.)), ("powerIn", dict(steps=30)),
    ("powerIn", dict(steps=30, inverse=True)), ("powerOut", dict(steps=30)),
    ("powerOut", dict(steps=30, inverse=True)),
    ("sine", dict(steps=30)), ("sineIn", dict(steps=30)),
    ("sineOut", dict(steps=30)), ("circle", dict(steps=30)),
    ("circleIn", dict(steps=30)), ("circleOut", dict(steps=30)),
    ("swing", dict(steps=30)), ("swingIn", dict(steps=30)),
    ("swingOut", dict(steps=30)), ("exp", dict(steps=30)),
    ("expIn", dict(steps=30)), ("expOut", dict(steps=30)),
    ("elastic", dict(steps=30)), ("elasticIn", dict(steps=30)),
    ("elasticOut", dict(steps=30, cyclical=True, delay_out=4)),
]


@pytest.mark.parametrize("name,kwargs", SCHEDULES,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_interpolation_matches_jax(name, kwargs):
  steps = np.arange(-2, 70).astype(np.int32)
  want = np.asarray(getattr(jinterp, name)(**kwargs)(jnp.asarray(steps)))
  sched = getattr(tinterp, name)(**kwargs)
  got = _np(sched(torch.from_numpy(steps)))
  np.testing.assert_allclose(got, want, rtol=SCHEDULE_TOL, atol=SCHEDULE_TOL)
  # one step at a time, as a training step calls it on its step count
  for s in (0, 7, 33):
    np.testing.assert_allclose(_np(sched(torch.tensor(s, dtype=torch.int32))),
                               want[s + 2], rtol=SCHEDULE_TOL,
                               atol=SCHEDULE_TOL)
  assert tinterp.get(name) is getattr(tinterp, name)
  assert sched.name == getattr(jinterp, name)(**kwargs).name


def test_elbo_estimators_match_jax():
  rs = np.random.RandomState(4)
  llk = {"llk_a": rs.randn(6).astype(np.float32),
         "llk_b": rs.randn(6).astype(np.float32)}
  kl = {"kl_z": np.abs(rs.randn(6)).astype(np.float32)}
  samples = (rs.randn(5, 6) * 30).astype(np.float32)
  jm, m = JaxVariationalModel(), VariationalModel()
  t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
  np.testing.assert_allclose(_np(m.elbo(t(llk), t(kl))),
                             np.asarray(jm.elbo(llk, kl)), rtol=1e-6)
  np.testing.assert_allclose(
      _np(m.importance_weighted(torch.from_numpy(samples))),
      np.asarray(jm.importance_weighted(samples)), rtol=1e-6, atol=1e-5)
  words = np.array([3., 0., 10., 2., 1., 4.], np.float32)
  np.testing.assert_allclose(
      _np(m.perplexity(torch.from_numpy(llk["llk_a"]),
                       torch.from_numpy(words))),
      np.asarray(jm.perplexity(llk["llk_a"], words)), rtol=1e-6)
  beta = tinterp.linear(vmin=0., vmax=2., steps=10)
  for step in (0, 4, 20):
    np.testing.assert_allclose(
        _np(m._schedule(beta, torch.tensor(step))),
        np.asarray(jm._schedule(jinterp.linear(vmin=0., vmax=2., steps=10),
                                step)), rtol=1e-6)
  assert m._schedule(2.5, 3).dtype == torch.float32
  assert float(m._schedule(2.5, 3)) == 2.5
