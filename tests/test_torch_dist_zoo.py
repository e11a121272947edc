"""The distribution zoo of the port against the JAX package's on the CPU:
the seven continuous families (``LogNormal``, ``Laplace``, ``Gamma``,
``Beta``, ``MultivariateNormalTriL``, ``NormalGamma``, ``LogUniform``),
the ten discrete ones (``ContinuousBernoulli``, ``RelaxedBernoulli``,
``RelaxedOneHotCategorical``, ``Poisson``, ``Binomial``, ``Multinomial``,
``DirichletMultinomial``, ``NegativeBinomial``, ``NegativeBinomialDisp``,
``ZeroInflated``), ``Batchwise`` and ``ConditionalTensor``.

  * ``log_prob`` (zero-heavy counts included), its gradient in every
    parameter, ``mean``, ``mode``, ``variance``, ``stddev``, ``entropy``
    and ``cdf`` where the JAX class defines them, and every registered KL
    pair, on the same parameters: within 1e-5 of each result's largest
    magnitude (the repo's rule for float32 sums of lgamma terms).
  * ``LogNormal``'s ``stddev`` and ``cdf`` are the log-normal's own, held
    against scipy: the JAX class inherits the Normal's (the scale, and
    the cdf of x under Normal(loc, scale)).
  * The reparameterised draws (LogNormal, Gamma, Beta, NormalGamma,
    LogUniform, RelaxedBernoulli, RelaxedOneHotCategorical) take JAX's
    draws (recorded by ``torch_zoo_common.jit_with_draws``; JAX's Gumbel
    variates drawn alongside) and give JAX's sample and its gradient.
  * Samplers that cannot be matched draw for draw (Laplace's, the counts')
    are held by their moments: 10⁵ draws' mean and variance within five
    standard errors of the analytic ones; the relaxed families by the
    share of draws above 1/2 (or of each argmax).
"""
import numpy as np
import pytest
import scipy.stats
import torch

import jax
import jax.numpy as jnp

import odin_tpu.bay.distributions as JD
import odin_tpu_torch.bay.distributions as PD
from odin_tpu_torch.training.core import Noise
from torch_zoo_common import jit_with_draws, to_torch

RTOL = 1e-5
N_DRAWS = 100_000


def close(got, want, rtol=RTOL, what=""):
  g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
      else np.asarray(got)
  w = np.asarray(want)
  assert g.shape == w.shape, (what, g.shape, w.shape)
  np.testing.assert_allclose(g, w, rtol=rtol,
                             atol=rtol * max(float(np.abs(w).max()), 1e-30),
                             err_msg=what)


def _tril(rs, d, n):
  raw = rs.randn(n, d, d).astype(np.float32) * 0.4
  raw = np.tril(raw)
  idx = np.arange(d)
  raw[:, idx, idx] = np.abs(raw[:, idx, idx]) + 0.6
  return raw


def _counts(rs, shape, lam=3.0, zeros=0.4):
  x = rs.poisson(lam, shape).astype(np.float32)
  x[rs.rand(*shape) < zeros] = 0
  return x


def family(name, rs):
  """(class name, {param: array}, values for log_prob, wrap) of one family;
  ``wrap(D, dist)`` builds a compound (ZeroInflated) from the base."""
  pos = lambda *s: (np.abs(rs.randn(*s)) + 0.3).astype(np.float32)
  real = lambda *s: rs.randn(*s).astype(np.float32)
  S = (3, 4)
  if name == "LogNormal":
    return "LogNormal", dict(loc=real(*S) * 0.5, scale=pos(*S)), pos(*S)
  if name == "Laplace":
    return "Laplace", dict(loc=real(*S), scale=pos(*S)), real(*S)
  if name == "Gamma":
    return "Gamma", dict(concentration=pos(*S) * 2,
                         rate=pos(*S)), pos(*S)
  if name == "Beta":
    return "Beta", dict(concentration1=pos(*S) * 2,
                        concentration0=pos(*S) * 2), \
        rs.uniform(0.05, 0.95, S).astype(np.float32)
  if name == "MultivariateNormalTriL":
    return name, dict(loc=real(3, 4), scale_tril=_tril(rs, 4, 3)), real(3, 4)
  if name == "NormalGamma":
    v = np.stack([real(*S), pos(*S)], -1)
    return name, dict(loc=real(*S), lam=pos(*S), alpha=pos(*S) * 3,
                      beta=pos(*S)), v
  if name == "LogUniform":
    low = pos(*S)
    return name, dict(low=low, high=low + pos(*S) * 3), \
        low + rs.uniform(0, 1, S).astype(np.float32)
  if name == "ContinuousBernoulli":
    logits = real(*S)
    logits[0, 0] = 0.0  # the 0.5 Taylor branch
    return name, dict(logits=logits), rs.uniform(0, 1, S).astype(np.float32)
  if name == "RelaxedBernoulli":
    return name, dict(temperature=np.float32(0.5), logits=real(*S)), \
        rs.uniform(0.01, 0.99, S).astype(np.float32)
  if name == "RelaxedOneHotCategorical":
    v = rs.dirichlet(np.ones(5), 3).astype(np.float32)
    return name, dict(temperature=np.float32(0.7), logits=real(3, 5)), v
  if name == "Poisson":
    return name, dict(log_rate=real(*S)), _counts(rs, S)
  if name == "Binomial":
    return name, dict(total_count=np.float32(7.0), logits=real(*S)), \
        rs.randint(0, 8, S).astype(np.float32)
  if name == "Multinomial":
    v = rs.multinomial(9, [0.2, 0.3, 0.1, 0.4], 3).astype(np.float32)
    return name, dict(total_count=np.float32(9.0), logits=real(3, 4)), v
  if name == "DirichletMultinomial":
    v = rs.multinomial(9, [0.2, 0.3, 0.1, 0.4], 3).astype(np.float32)
    return name, dict(total_count=np.float32(9.0),
                      concentration=pos(3, 4) * 2), v
  if name == "NegativeBinomial":
    return name, dict(total_count=pos(*S) * 3, logits=real(*S)), \
        _counts(rs, S)
  if name == "NegativeBinomialDisp":
    return name, dict(loc=pos(*S) * 3, disp=pos(*S) * 2), _counts(rs, S)
  raise KeyError(name)


FAMILIES = ["LogNormal", "Laplace", "Gamma", "Beta", "MultivariateNormalTriL",
            "NormalGamma", "LogUniform", "ContinuousBernoulli",
            "RelaxedBernoulli", "RelaxedOneHotCategorical", "Poisson",
            "Binomial", "Multinomial", "DirichletMultinomial",
            "NegativeBinomial", "NegativeBinomialDisp"]
ZERO_INFLATED = ["Poisson", "NegativeBinomialDisp", "NegativeBinomial",
                 "Bernoulli"]
# the non-differentiable count parameters
_FIXED = ("total_count",)


def build(D, cls, params):
  if D is JD:
    return getattr(D, cls)(**{k: jnp.asarray(v) for k, v in params.items()})
  return getattr(D, cls)(**{k: torch.from_numpy(np.array(v))
                            for k, v in params.items()})


def zero_inflated(D, base, params, gate):
  if base == "Bernoulli":
    count = build(D, "Bernoulli", params)
  else:
    count = build(D, base, params)
  g = jnp.asarray(gate) if D is JD else torch.from_numpy(gate)
  return D.ZeroInflated(count, logits=g)


def _methods(j):
  """The statistics the JAX distribution defines (computable)."""
  out = []
  for name in ("mean", "mode", "variance", "stddev", "entropy"):
    try:
      np.asarray(getattr(j, name)())
      out.append(name)
    except (NotImplementedError, AttributeError):
      pass
  return out


@pytest.mark.parametrize("name", FAMILIES)
def test_family_matches_jax(name):
  rs = np.random.RandomState(FAMILIES.index(name) + 1)
  cls, params, x = family(name, rs)
  j, p = build(JD, cls, params), build(PD, cls, params)
  assert tuple(p.batch_shape) == tuple(j.batch_shape)
  assert tuple(p.event_shape) == tuple(j.event_shape)
  close(p.log_prob(torch.from_numpy(x)), j.log_prob(jnp.asarray(x)),
        what="log_prob")
  for m in _methods(j):
    if cls == "LogNormal" and m == "stddev":
      continue
    close(getattr(p, m)(), getattr(j, m)(), what=m)
  if hasattr(j, "cdf") and cls != "LogNormal":
    close(p.cdf(torch.from_numpy(x)), j.cdf(jnp.asarray(x)), what="cdf")
  # the gradient of log_prob in every differentiable parameter
  names = [k for k in params if k not in _FIXED and np.ndim(params[k])]
  jg = jax.grad(lambda *a: jnp.sum(build(JD, cls, {
      **params, **dict(zip(names, a))}).log_prob(jnp.asarray(x))),
      argnums=tuple(range(len(names))))(*(jnp.asarray(params[k])
                                          for k in names))
  ts = {k: torch.from_numpy(np.array(params[k])).requires_grad_(True)
        for k in names}
  lp = getattr(PD, cls)(**{**{k: torch.from_numpy(np.array(v))
                              for k, v in params.items()}, **ts})
  lp.log_prob(torch.from_numpy(x)).sum().backward()
  for k, g in zip(names, jg):
    assert torch.isfinite(ts[k].grad).all(), k
    close(ts[k].grad, g, what=f"d log_prob / d {k}")


def test_lognormal_stddev_and_cdf_are_the_lognormals():
  rs = np.random.RandomState(3)
  _, params, x = family("LogNormal", rs)
  p = build(PD, "LogNormal", params)
  ref = scipy.stats.lognorm(s=params["scale"], scale=np.exp(params["loc"]))
  np.testing.assert_allclose(p.stddev().numpy(), ref.std(), rtol=1e-5)
  np.testing.assert_allclose(p.cdf(torch.from_numpy(x)).numpy(), ref.cdf(x),
                             rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("base", ZERO_INFLATED)
def test_zero_inflated_matches_jax(base):
  """Zero-heavy counts: the log-density of both branches, the moments and
  the gradients, which stay finite on the branch not taken."""
  rs = np.random.RandomState(20 + ZERO_INFLATED.index(base))
  if base == "Bernoulli":
    params = dict(logits=rs.randn(3, 4).astype(np.float32))
    x = (rs.rand(3, 4) < 0.3).astype(np.float32)
  else:
    _, params, x = family(base, rs)
  gate = rs.randn(3, 4).astype(np.float32)
  assert (x == 0).mean() > 0.2 and (x > 0).any()
  j = zero_inflated(JD, base, params, gate)
  p = zero_inflated(PD, base, params, gate)
  close(p.log_prob(torch.from_numpy(x)), j.log_prob(jnp.asarray(x)),
        what="log_prob")
  close(p.mean(), j.mean(), what="mean")
  close(p.variance(), j.variance(), what="variance")
  names = [k for k in params if k not in _FIXED]
  jg = jax.grad(lambda g, *a: jnp.sum(zero_inflated(
      JD, base, {**params, **dict(zip(names, a))}, g).log_prob(
          jnp.asarray(x))), argnums=tuple(range(len(names) + 1)))(
              jnp.asarray(gate), *(jnp.asarray(params[k]) for k in names))
  ts = [torch.from_numpy(gate.copy()).requires_grad_(True)] + [
      torch.from_numpy(params[k].copy()).requires_grad_(True) for k in names]
  count = getattr(PD, base)(**{**{k: torch.from_numpy(v) for k, v in
                                  params.items()},
                               **dict(zip(names, ts[1:]))})
  PD.ZeroInflated(count, logits=ts[0]).log_prob(
      torch.from_numpy(x)).sum().backward()
  for t, g, k in zip(ts, jg, ["gate"] + names):
    assert torch.isfinite(t.grad).all(), k
    close(t.grad, g, what=f"d log_prob / d {k}")


def _kl_pairs(rs):
  """(name, JAX q, JAX p, port q, port p) of every registered pair."""
  out = []
  for cls in ("LogNormal", "Gamma", "Beta", "MultivariateNormalTriL"):
    _, a, _ = family(cls, rs)
    _, b, _ = family(cls, rs)
    out.append((cls, build(JD, cls, a), build(JD, cls, b),
                build(PD, cls, a), build(PD, cls, b)))
  _, a, _ = family("Poisson", rs)
  _, b, _ = family("Poisson", rs)
  out.append(("Poisson", build(JD, "Poisson", a), build(JD, "Poisson", b),
              build(PD, "Poisson", a), build(PD, "Poisson", b)))
  loc = rs.randn(3, 4).astype(np.float32)
  diag = (np.abs(rs.randn(3, 4)) + 0.3).astype(np.float32)
  _, t, _ = family("MultivariateNormalTriL", rs)
  out.append(("MVNDiag->TriL",
              build(JD, "MultivariateNormalDiag", dict(loc=loc,
                                                       scale_diag=diag)),
              build(JD, "MultivariateNormalTriL", t),
              build(PD, "MultivariateNormalDiag", dict(loc=loc,
                                                       scale_diag=diag)),
              build(PD, "MultivariateNormalTriL", t)))
  ploc, pdiag = np.zeros(4, np.float32), np.ones(4, np.float32) * 1.5
  out.append(("Normal->MVNDiag",
              build(JD, "Normal", dict(loc=loc, scale=diag)),
              build(JD, "MultivariateNormalDiag", dict(loc=ploc,
                                                       scale_diag=pdiag)),
              build(PD, "Normal", dict(loc=loc, scale=diag)),
              build(PD, "MultivariateNormalDiag", dict(loc=ploc,
                                                       scale_diag=pdiag))))
  y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 3)]
  q, pp = out[-2][1:3], out[-2][3:5]
  out.append(("ConditionalTensor",
              JD.ConditionalTensor(out[3][1], y),
              JD.ConditionalTensor(out[3][2], y),
              PD.ConditionalTensor(out[3][3], torch.from_numpy(y)),
              PD.ConditionalTensor(out[3][4], torch.from_numpy(y))))
  return out


def test_registered_kls_match_jax():
  pairs = _kl_pairs(np.random.RandomState(40))
  for name, jq, jp, pq, pp in pairs:
    close(pq.kl_divergence(pp), jq.kl_divergence(jp), what=name)
  # the registry knows the same pairs
  from odin_tpu.bay.distributions.base import _KL_REGISTRY as JR
  from odin_tpu_torch.bay.distributions.base import _KL_REGISTRY as PR
  key = lambda pair: (pair[0].__name__, pair[1].__name__)
  assert {key(k) for k in JR} <= {key(k) for k in PR}


# -- draws -------------------------------------------------------------------
REPARAM = ["LogNormal", "Gamma", "Beta", "NormalGamma", "LogUniform",
           "RelaxedBernoulli", "MultivariateNormalTriL"]


@pytest.mark.parametrize("name", REPARAM)
def test_reparameterised_draws_match_jax(name):
  """JAX's draws injected: the same sample, and the same gradient of its
  sum in every parameter."""
  rs = np.random.RandomState(60 + REPARAM.index(name))
  cls, params, _ = family(name, rs)
  names = [k for k in params if np.ndim(params[k])]

  def jsample(*a):
    d = build(JD, cls, {**params, **dict(zip(names, a))})
    return d.sample(jax.random.PRNGKey(5), (2,))

  jargs = tuple(jnp.asarray(params[k]) for k in names)
  sample, draws = jit_with_draws(jsample)(*jargs)
  jgrad = jax.grad(lambda *a: jnp.sum(jsample(*a)),
                   argnums=tuple(range(len(names))))(*jargs)
  ts = {k: torch.from_numpy(params[k].copy()).requires_grad_(True)
        for k in names}
  p = getattr(PD, cls)(**{**{k: torch.from_numpy(np.array(v))
                             for k, v in params.items()}, **ts})
  got = p.sample_from(Noise(eps=to_torch(draws)), (2,))
  close(got, sample, what="sample")
  got.sum().backward()
  for k, g in zip(names, jgrad):
    close(ts[k].grad, g, what=f"d sample / d {k}")


def test_relaxed_onehot_draw_matches_jax():
  rs = np.random.RandomState(70)
  _, params, _ = family("RelaxedOneHotCategorical", rs)
  j = build(JD, "RelaxedOneHotCategorical", params)
  key = jax.random.PRNGKey(9)
  want = j.sample(key, (2,))
  g = jax.random.gumbel(key, (2, 3, 5))  # the variates JAX's sample adds
  got = build(PD, "RelaxedOneHotCategorical", params).sample(
      (2,), eps=[torch.from_numpy(np.array(g))])
  close(got, want, what="sample")


MOMENTS = ["LogNormal", "Laplace", "Gamma", "Beta", "MultivariateNormalTriL",
           "Poisson", "Binomial", "Multinomial", "NegativeBinomial",
           "NegativeBinomialDisp", "DirichletMultinomial", "LogUniform"]


@pytest.mark.parametrize("name", MOMENTS)
def test_sample_moments(name):
  rs = np.random.RandomState(80 + MOMENTS.index(name))
  cls, params, _ = family(name, rs)
  if name == "LogNormal":
    # a log-normal of scale above 1 has so heavy a tail that 10⁵ draws
    # do not estimate its variance (nor its error, from the 4th moment)
    params["scale"] = np.clip(params["scale"], None, 0.5)
  p = build(PD, cls, params)
  gen = torch.Generator().manual_seed(MOMENTS.index(name))
  x = p.sample((N_DRAWS,), generator=gen).double()
  assert tuple(x.shape) == (N_DRAWS,) + tuple(p.batch_shape) + tuple(
      p.event_shape)
  mean = p.mean().double()
  var = p.variance().double() if name not in ("DirichletMultinomial",
                                              "LogUniform") \
      else x.var(0)
  se = torch.sqrt(var / N_DRAWS)
  assert (torch.abs(x.mean(0) - mean) <= 5 * se + 1e-9).all(), name
  if name not in ("DirichletMultinomial", "LogUniform"):
    # the sample variance's standard error, from the fourth moment
    m4 = ((x - x.mean(0)) ** 4).mean(0)
    se_var = torch.sqrt((m4 - x.var(0) ** 2) / N_DRAWS)
    assert (torch.abs(x.var(0) - var) <= 5 * se_var + 1e-9).all(), name


def test_zero_inflated_sample_moments():
  rs = np.random.RandomState(90)
  _, params, _ = family("NegativeBinomialDisp", rs)
  gate = rs.randn(3, 4).astype(np.float32)
  p = zero_inflated(PD, "NegativeBinomialDisp", params, gate)
  x = p.sample((N_DRAWS,), generator=torch.Generator().manual_seed(1))
  x = x.double()
  se = torch.sqrt(p.variance().double() / N_DRAWS)
  assert (torch.abs(x.mean(0) - p.mean().double()) <= 5 * se).all()
  zeros = (x == 0).double().mean(0)
  pi = torch.sigmoid(torch.from_numpy(gate)).double()
  nb0 = torch.exp(p.count_distribution.log_prob(torch.zeros(3, 4))).double()
  want = pi + (1 - pi) * nb0
  assert (torch.abs(zeros - want) <= 5 * torch.sqrt(
      want * (1 - want) / N_DRAWS)).all()


def test_relaxed_draws_follow_their_logits():
  rs = np.random.RandomState(91)
  gen = torch.Generator().manual_seed(2)
  _, params, _ = family("RelaxedBernoulli", rs)
  p = build(PD, "RelaxedBernoulli", params)
  share = (p.sample((N_DRAWS,), generator=gen) > 0.5).double().mean(0)
  want = torch.sigmoid(torch.from_numpy(params["logits"])).double()
  assert (torch.abs(share - want) <= 5 * torch.sqrt(
      want * (1 - want) / N_DRAWS)).all()
  _, params, _ = family("RelaxedOneHotCategorical", rs)
  p = build(PD, "RelaxedOneHotCategorical", params)
  idx = p.sample((N_DRAWS,), generator=gen).argmax(-1)
  share = torch.nn.functional.one_hot(idx, 5).double().mean(0)
  want = torch.softmax(torch.from_numpy(params["logits"]), -1).double()
  assert (torch.abs(share - want) <= 5 * torch.sqrt(
      want * (1 - want) / N_DRAWS) + 1e-9).all()


# -- containers ----------------------------------------------------------------
def test_batchwise_matches_jax():
  rs = np.random.RandomState(95)
  parts = [(rs.randn(n, 4).astype(np.float32),
            (np.abs(rs.randn(n, 4)) + 0.3).astype(np.float32))
           for n in (3, 5)]
  j = JD.Batchwise([JD.MultivariateNormalDiag(jnp.asarray(l), jnp.asarray(s))
                    for l, s in parts])
  p = PD.Batchwise([PD.MultivariateNormalDiag(torch.from_numpy(l),
                                              torch.from_numpy(s))
                    for l, s in parts])
  assert tuple(p.batch_shape) == tuple(j.batch_shape) == (8,)
  assert tuple(p.event_shape) == tuple(j.event_shape)
  x = rs.randn(8, 4).astype(np.float32)
  close(p.log_prob(torch.from_numpy(x)), j.log_prob(jnp.asarray(x)),
        what="log_prob")
  for m in ("mean", "mode", "variance", "stddev"):
    close(getattr(p, m)(), getattr(j, m)(), what=m)
  prior_j = JD.MultivariateNormalDiag(jnp.zeros(4), jnp.ones(4))
  prior_p = PD.MultivariateNormalDiag(torch.zeros(4), torch.ones(4))
  close(p.kl_divergence(prior_p), j.kl_divergence(prior_j), what="kl")
  close(p.kl_divergence(p), j.kl_divergence(j), what="kl batchwise")
  sample, draws = jit_with_draws(lambda k: j.sample(k, (2,)))(
      jax.random.PRNGKey(3))
  close(p.sample_from(Noise(eps=to_torch(draws)), (2,)), sample,
        what="sample")


def test_conditional_tensor_matches_jax():
  rs = np.random.RandomState(96)
  loc = rs.randn(5, 4).astype(np.float32)
  scale = (np.abs(rs.randn(5, 4)) + 0.3).astype(np.float32)
  y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 5)]
  for dims in (1, 0):  # an event axis, and a scalar family
    jbase = JD.MultivariateNormalDiag(jnp.asarray(loc), jnp.asarray(scale)) \
        if dims else JD.Normal(jnp.asarray(loc[:, 0]), jnp.asarray(scale[:, 0]))
    pbase = PD.MultivariateNormalDiag(torch.from_numpy(loc),
                                      torch.from_numpy(scale)) \
        if dims else PD.Normal(torch.from_numpy(loc[:, 0]),
                               torch.from_numpy(scale[:, 0]))
    j = JD.ConditionalTensor(jbase, jnp.asarray(y))
    p = PD.ConditionalTensor(pbase, torch.from_numpy(y))
    assert tuple(p.event_shape) == tuple(j.event_shape)
    assert tuple(p.batch_shape) == tuple(j.batch_shape)
    for m in ("mean", "mode", "variance", "stddev", "entropy"):
      close(getattr(p, m)(), getattr(j, m)(), what=m)
    x = np.asarray(j.mean()) + rs.randn(*j.mean().shape).astype(np.float32)
    close(p.log_prob(torch.from_numpy(x)), j.log_prob(jnp.asarray(x)),
          what="log_prob of a full event")
    sample, draws = jit_with_draws(lambda k: j.sample(k, (2,)))(
        jax.random.PRNGKey(4))
    close(p.sample_from(Noise(eps=to_torch(draws)), (2,)), sample,
          what="sample")


def test_kldivergence_matches_jax():
  """``KLdivergence``: no prior gives 0; the analytic KL (with free bits
  too) is JAX's; the MC estimate from its own seeded draws agrees with the
  analytic one within its standard error."""
  from odin_tpu.bay.helpers import KLdivergence as JKL
  from odin_tpu_torch.bay.helpers import KLdivergence as PKL
  rs = np.random.RandomState(97)
  loc = rs.randn(3, 4).astype(np.float32)
  scale = (np.abs(rs.randn(3, 4)) + 0.3).astype(np.float32)
  jq = JD.MultivariateNormalDiag(jnp.asarray(loc), jnp.asarray(scale))
  pq = PD.MultivariateNormalDiag(torch.from_numpy(loc),
                                 torch.from_numpy(scale))
  jp = JD.MultivariateNormalDiag(jnp.zeros(4), jnp.ones(4))
  pp = PD.MultivariateNormalDiag(torch.zeros(4), torch.ones(4))
  assert float(PKL(pq)()) == float(JKL(jq)()) == 0.0
  for kw in (dict(analytic=True), dict(analytic=True, free_bits=0.5)):
    close(PKL(pq, pp, **kw)(), JKL(jq, jp, **kw)(), what=str(kw))
  mc = PKL(pq, pp, sample_shape=20000, seed=3)()
  draws = pq.sample((20000,), generator=torch.Generator().manual_seed(3))
  se = (pq.log_prob(draws) - pp.log_prob(draws)).std(0) / np.sqrt(20000)
  exact = PKL(pq, pp, analytic=True)()
  assert mc.shape == exact.shape == (3,)
  assert bool((torch.abs(mc - exact) <= 5 * se).all())
