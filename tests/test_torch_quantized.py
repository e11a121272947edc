"""The port's Logistic, Uniform, Categorical, quantized family, mixtures and
the image likelihoods' aliases against the JAX package's, on the same
numpy inputs: log_prob, cdf, the moments, samples from JAX's own draws
(recorded with ``torch_zoo_common.jit_with_draws`` and replayed), and
gradients, at rtol 1e-5 (1e-4 on gradients).

A quantized log-likelihood is the log of a CDF difference (or of one
minus a CDF at the top edge).  Where that difference is a few float32
steps of the CDFs' rounding (a confident location far from the bin) the
two packages' CDFs, whose sigmoid and erf differ by one step in a few
elements in a thousand (XLA's and ATen's own exp and erf), move it by a
step.  Each element is held within the rounding its float64 value
implies (``_allowance``): ``err / q`` on the log, where q is the
logged probability and err the float32 rounding of the CDFs it is made
of, and the same relative share of its gradient; where q is below 16·err
both packages are at rounding level and only a finite value within the
1e-12 floor is held.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odin_tpu.bay.distributions as JD
import odin_tpu_torch.bay.distributions as PD
from odin_tpu.bay.distribution_alias import parse_distribution as jparse
from odin_tpu_torch.bay.distribution_alias import parse_distribution as pparse
from odin_tpu_torch.training.core import Noise
from torch_zoo_common import jit_with_draws, to_torch

RTOL, GRAD_RTOL = 1e-5, 1e-4
EPS32 = float(np.finfo(np.float32).eps)


def close(got, want, rtol=RTOL, atol=0.0, what=""):
  got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
      else np.asarray(got)
  want = np.asarray(want)
  assert got.shape == want.shape, (got.shape, want.shape, what)
  np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def t(a):
  return torch.tensor(np.asarray(a), requires_grad=True)


def _grads(jfn, pfn, *arrays):
  """(JAX's gradients of sum(jfn) in each array, the port's of sum(pfn))."""
  jg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a)), argnums=tuple(
      range(len(arrays)))))(*(jnp.asarray(a) for a in arrays))
  ts = [t(a) for a in arrays]
  torch.sum(pfn(*ts)).backward()
  return [np.asarray(g) for g in jg], [x.grad for x in ts]


# ---------------------------------------------------------------------------
# Logistic, Uniform, Categorical
# ---------------------------------------------------------------------------
def test_logistic_matches_jax():
  rs = np.random.RandomState(0)
  loc = rs.randn(3, 4).astype(np.float32)
  scale = rs.uniform(0.3, 2.0, (3, 4)).astype(np.float32)
  x = (rs.randn(3, 4) * 3).astype(np.float32)
  jd, pd = JD.Logistic(loc, scale), PD.Logistic(loc, scale)
  for name in ("log_prob", "cdf", "log_cdf"):
    close(getattr(pd, name)(torch.from_numpy(x)), getattr(jd, name)(x),
          what=name)
  for name in ("mean", "mode", "variance", "entropy"):
    close(getattr(pd, name)(), getattr(jd, name)(), what=name)
  sample, draws = jit_with_draws(lambda k: jd.sample(k, (2,)))(
      jax.random.PRNGKey(3))
  close(pd.sample((2,), eps=to_torch(draws)[0]), sample, what="sample")
  close(pd.sample_from(Noise(eps=to_torch(draws)), (2,)), sample,
        what="sample_from")
  jg, pg = _grads(lambda l, s: JD.Logistic(l, s).log_prob(x),
                  lambda l, s: PD.Logistic(l, s).log_prob(
                      torch.from_numpy(x)), loc, scale)
  for g, w in zip(pg, jg):
    close(g, w, GRAD_RTOL, 1e-6)


def test_uniform_matches_jax():
  rs = np.random.RandomState(1)
  low = rs.randn(5).astype(np.float32)
  high = low + rs.uniform(0.5, 3.0, 5).astype(np.float32)
  x = np.stack([low - 0.1, low, 0.5 * (low + high), high, high + 0.1])
  jd, pd = JD.Uniform(low, high), PD.Uniform(low, high)
  for name in ("log_prob", "cdf"):
    close(getattr(pd, name)(torch.from_numpy(x)), getattr(jd, name)(x),
          what=name)
  with np.errstate(divide="ignore"):
    log_cdf = np.log(np.asarray(jd.cdf(x)))
  close(pd.log_cdf(torch.from_numpy(x)), log_cdf, what="log_cdf")
  for name in ("mean", "variance", "entropy"):
    close(getattr(pd, name)(), getattr(jd, name)(), what=name)
  sample, draws = jit_with_draws(lambda k: jd.sample(k, (3,)))(
      jax.random.PRNGKey(4))
  close(pd.sample_from(Noise(eps=to_torch(draws)), (3,)), sample,
        what="sample")
  jg, pg = _grads(lambda lo, hi: JD.Uniform(lo, hi).entropy(),
                  lambda lo, hi: PD.Uniform(lo, hi).entropy(), low, high)
  for g, w in zip(pg, jg):
    close(g, w, GRAD_RTOL, 1e-6)


def test_categorical_matches_jax():
  rs = np.random.RandomState(2)
  logits = rs.randn(4, 6).astype(np.float32)
  other = rs.randn(4, 6).astype(np.float32)
  x = rs.randint(0, 6, 4)
  jd, pd = JD.Categorical(logits=logits), PD.Categorical(logits=logits)
  close(pd.log_prob(torch.from_numpy(x)), jd.log_prob(x), what="log_prob")
  close(pd.entropy(), jd.entropy(), what="entropy")
  close(pd.probs, jd.probs, what="probs")
  assert np.array_equal(pd.mode().numpy(), np.asarray(jd.mode()))
  close(pd.kl_divergence(PD.Categorical(logits=other)),
        jd.kl_divergence(JD.Categorical(logits=other)), what="kl")
  sample, draws = jit_with_draws(lambda k: jd.sample(k, (5,)))(
      jax.random.PRNGKey(5))
  got = pd.sample_from(Noise(eps=to_torch(draws)), (5,))
  assert np.array_equal(got.numpy(), np.asarray(sample))


# ---------------------------------------------------------------------------
# the quantized logistic
# ---------------------------------------------------------------------------
# locations below, on, between and beyond the grid's edges, in bins
LOCS = np.array([-20.0, -0.5, 0.0, 0.3, 1.7, 127.5, 200.2, 254.0, 254.7,
                 255.0, 255.5, 280.0], np.float32)
SCALES = np.array([0.05, 0.5, 2.0, 12.0], np.float32)
BINS = np.array([0, 1, 2, 100, 127, 128, 200, 253, 254, 255], np.float32)


def _grid():
  """(loc, scale, x in [0, 1]) over every location, scale and bin."""
  l, s, b = np.meshgrid(LOCS, SCALES, BINS, indexing="ij")
  return l.ravel(), s.ravel(), (b / 255.0).ravel().astype(np.float32)


def _allowance(q, err):
  """(atol on log q, relative allowance on its gradient, rounding-level
  mask) of a float64 probability q whose float32 value carries `err`."""
  q = np.maximum(q, 1e-12)
  level = q < 16 * err
  return (np.where(level, 28.0, err / q), np.where(level, np.inf, err / q),
          level)


def _qlogistic_allowance(loc, scale, x):
  g = x.astype(np.float64) * 255.0
  cdf = lambda v: 1.0 / (1.0 + np.exp(-(v - loc.astype(np.float64)) / scale))
  with np.errstate(over="ignore"):
    plus, minus = cdf(g + 0.5), cdf(g - 0.5)
  q = np.where(g <= 0, plus, np.where(g >= 255, 1.0 - minus, plus - minus))
  err = np.where(g <= 0, 4 * EPS32 * plus,
                 np.where(g >= 255, 4 * EPS32, 4 * EPS32 * (plus + minus)))
  return _allowance(q, err)


def _held(got, want, atol, rel, level, what):
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  want = np.asarray(want)
  assert np.isfinite(got).all(), what
  bound = np.where(level, atol, RTOL * np.abs(want) + atol + 1e-30)
  np.testing.assert_array_less(np.abs(got - want), bound, err_msg=what)


def test_quantized_logistic_log_prob_matches_jax():
  loc, scale, x = _grid()
  jd, pd = JD.QuantizedLogistic(loc, scale), PD.QuantizedLogistic(loc, scale)
  atol, _, level = _qlogistic_allowance(loc, scale, x)
  got = pd.log_prob(torch.from_numpy(x))
  _held(got, jd.log_prob(x), atol, None, level, "log_prob")
  for name in ("mean", "mode", "variance"):
    close(getattr(pd, name)(), getattr(jd, name)(), what=name)
  raw = JD.QuantizedLogistic(loc, scale, inputs_domain="raw")
  close(PD.QuantizedLogistic(loc, scale, inputs_domain="raw").log_prob(
      torch.from_numpy(x * 255)), raw.log_prob(x * 255), what="raw domain")


@pytest.mark.parametrize("wrt", ["loc", "scale", "x"])
def test_quantized_logistic_gradients_match_jax(wrt):
  """Gradients at locations on, between and beyond the 0/255 edges, in
  the location, the scale and the data: finite everywhere (no NaN from
  the unused branches) and JAX's."""
  loc, scale, x = _grid()
  arrays = dict(loc=loc, scale=scale, x=x)
  i = list(arrays).index(wrt)

  def jfn(a):
    args = [jnp.asarray(v) for v in arrays.values()]
    args[i] = a
    return JD.QuantizedLogistic(args[0], args[1]).log_prob(args[2])

  def pfn(a):
    args = [torch.from_numpy(v) for v in arrays.values()]
    args[i] = a
    return PD.QuantizedLogistic(args[0], args[1]).log_prob(args[2])

  (jg,), (pg,) = _grads(jfn, pfn, arrays[wrt])
  pg = pg.numpy()
  assert np.isfinite(pg).all()
  _, rel, level = _qlogistic_allowance(loc, scale, x)
  keep = ~level
  # d/dx is 255 d/d(grid value): its absolute floor scales with it
  floor = 1e-6 * (255.0 if wrt == "x" else 1.0)
  np.testing.assert_array_less(
      np.abs(pg - jg)[keep],
      (GRAD_RTOL + rel[keep]) * np.abs(jg[keep]) + floor)


def test_quantized_logistic_sample_matches_jax():
  rs = np.random.RandomState(6)
  loc = rs.uniform(-10, 265, (4, 5)).astype(np.float32)
  scale = rs.uniform(0.2, 5, (4, 5)).astype(np.float32)
  jd, pd = JD.QuantizedLogistic(loc, scale), PD.QuantizedLogistic(loc, scale)
  sample, draws = jit_with_draws(lambda k: jd.sample(k, (3,)))(
      jax.random.PRNGKey(7))
  got = pd.sample_from(Noise(eps=to_torch(draws)), (3,))
  close(got, sample, what="sample")
  assert got.min() >= 0 and got.max() <= 1


def test_mixture_quantized_logistic_matches_jax():
  """10 components on 32x32x3 images: the logsumexp over components stays
  finite (no underflow) and equals JAX's, gradients too."""
  rs = np.random.RandomState(8)
  K, shape = 10, (32, 32, 3)
  logits = rs.randn(2, K).astype(np.float32)
  locs = rs.uniform(-5, 260, (2, K) + shape).astype(np.float32)
  scales = rs.uniform(0.3, 8, (2, K) + shape).astype(np.float32)
  x = (rs.randint(0, 256, (2,) + shape) / 255.0).astype(np.float32)

  def jfn(lg, lc, sc):
    comp = JD.Independent(JD.QuantizedLogistic(lc, sc), 3)
    return JD.MixtureSameFamily(JD.Categorical(logits=lg), comp).log_prob(x)

  def pfn(lg, lc, sc):
    comp = PD.Independent(PD.QuantizedLogistic(lc, sc), 3)
    return PD.MixtureSameFamily(PD.Categorical(logits=lg), comp).log_prob(
        torch.from_numpy(x))

  want = np.asarray(jfn(logits, locs, scales))
  got = pfn(*(torch.from_numpy(a) for a in (logits, locs, scales)))
  assert np.isfinite(got.numpy()).all() and got.shape == (2,)
  close(got, want)
  # the responsibilities are exps of differences of two sums of 3072 log
  # terms, each sum rounded to about one float32 step of its magnitude
  lp = np.asarray(JD.Independent(JD.QuantizedLogistic(locs, scales), 3)
                  .log_prob(x[:, None]))
  rel = GRAD_RTOL + 4 * float(np.spacing(np.float32(np.abs(lp).max())))
  jg, pg = _grads(jfn, pfn, logits, locs, scales)
  for g, w in zip(pg, jg):
    close(g, w, rel, rel * float(np.abs(w).max()))
  # the factory: a mixture of K per pixel (components on the last axis)
  per_pixel = (logits[:, None, None, None], np.moveaxis(locs, 1, -1),
               np.moveaxis(scales, 1, -1))
  close(PD.MixtureQuantizedLogistic(*per_pixel).log_prob(torch.from_numpy(x)),
        JD.MixtureQuantizedLogistic(*per_pixel).log_prob(x),
        what="per-pixel mixture")


# ---------------------------------------------------------------------------
# Quantized, qNormal, qUniform
# ---------------------------------------------------------------------------
def _qnormal_allowance(loc, scale, x, low, high):
  from math import erf
  cdf = np.vectorize(lambda v, m, sd: 0.5 * (1.0 + erf((v - m) /
                                                       (sd * 2 ** 0.5))))
  plus = cdf(x + 0.5, loc, scale)
  minus = cdf(x - 0.5, loc, scale)
  q = plus - minus
  if low is not None:
    q = np.where(x <= low, plus, q)
  if high is not None:
    q = np.where(x >= high, 1.0 - minus, q)
  return _allowance(q, 4 * EPS32)


@pytest.mark.parametrize("edges", [(None, None), (0, 10), (-3, None)])
def test_quantized_normal_matches_jax(edges):
  rs = np.random.RandomState(9)
  loc = rs.uniform(-2, 12, 6).astype(np.float32)
  scale = rs.uniform(0.5, 3, 6).astype(np.float32)
  x = np.arange(-4, 14, dtype=np.float32)[:, None]
  jd = JD.qNormal(loc, scale, *edges)
  pd = PD.qNormal(loc, scale, *edges)
  allow = _qnormal_allowance(loc, scale, x, *edges)
  _held(pd.log_prob(torch.from_numpy(x)), jd.log_prob(x), *allow,
        "log_prob")
  close(pd.prob(torch.from_numpy(x)), jd.prob(x), atol=64 * EPS32,
        what="prob")
  close(pd.mean(), jd.mean())
  close(pd.mode(), jd.mode())
  sample, draws = jit_with_draws(lambda k: jd.sample(k, (4,)))(
      jax.random.PRNGKey(10))
  close(pd.sample_from(Noise(eps=to_torch(draws)), (4,)), sample)
  # one location and scale an element, so that each gradient is one
  # bin's term, held within its own rounding (those at rounding level
  # only finite)
  full = lambda a: np.ascontiguousarray(np.broadcast_to(a, allow[0].shape))
  jg, pg = _grads(lambda l, s: JD.qNormal(l, s, *edges).log_prob(x),
                  lambda l, s: PD.qNormal(l, s, *edges).log_prob(
                      torch.from_numpy(x)), full(loc), full(scale))
  keep = ~allow[2]
  for g, w in zip(pg, jg):
    g = g.numpy()
    assert np.isfinite(g).all()
    np.testing.assert_array_less(
        np.abs(g - w)[keep], (GRAD_RTOL + allow[1][keep]) *
        np.abs(w[keep]) + 1e-6)


def test_quantized_uniform_matches_jax():
  low = np.array([0.0, -2.5, 1.2], np.float32)
  high = np.array([10.0, 3.5, 9.9], np.float32)
  x = np.arange(-3, 12, dtype=np.float32)[:, None]
  for edges in ((None, None), (0, 9)):
    jd, pd = JD.qUniform(low, high, *edges), PD.qUniform(low, high, *edges)
    close(pd.log_prob(torch.from_numpy(x)), jd.log_prob(x), what=str(edges))
    close(pd.mean(), jd.mean())
    sample, draws = jit_with_draws(lambda k: jd.sample(k, (4,)))(
        jax.random.PRNGKey(11))
    close(pd.sample_from(Noise(eps=to_torch(draws)), (4,)), sample)


# ---------------------------------------------------------------------------
# mixtures and the aliases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("covariance", ["diag", "none"])
def test_gaussian_mixture_matches_jax(covariance):
  rs = np.random.RandomState(12)
  K, d = 4, 3
  logits = rs.randn(5, K).astype(np.float32)
  shape = (5, K, d) if covariance == "diag" else (5, K)
  locs = rs.randn(*shape).astype(np.float32)
  scales = rs.uniform(0.3, 2, shape).astype(np.float32)
  x = rs.randn(*((5, d) if covariance == "diag" else (5,))).astype(
      np.float32)
  jd = JD.GaussianMixture(logits, locs, scales, covariance)
  pd = PD.GaussianMixture(logits, locs, scales, covariance)
  assert tuple(pd.batch_shape) == tuple(jd.batch_shape)
  assert tuple(pd.event_shape) == tuple(jd.event_shape)
  close(pd.log_prob(torch.from_numpy(x)), jd.log_prob(x), what="log_prob")
  close(pd.mean(), jd.mean(), what="mean")
  close(pd.variance(), jd.variance(), what="variance")
  sample, draws = jit_with_draws(lambda k: jd.sample(k, (2,)))(
      jax.random.PRNGKey(13))
  close(pd.sample_from(Noise(eps=to_torch(draws)), (2,)), sample,
        what="sample")
  jg, pg = _grads(
      lambda lg, lc, sc: JD.GaussianMixture(lg, lc, sc, covariance).log_prob(
          x),
      lambda lg, lc, sc: PD.GaussianMixture(lg, lc, sc, covariance).log_prob(
          torch.from_numpy(x)), logits, locs, scales)
  for g, w in zip(pg, jg):
    close(g, w, GRAD_RTOL, 1e-6)


def test_gaussian_mixture_tril_raises():
  """The full-covariance mixture is ported: ``GaussianMixture(...,
  'tril')`` and the 'gmmtril' alias score as JAX's."""
  rs = np.random.RandomState(12)
  raw = rs.randn(2, 20).astype(np.float32)
  got = pparse("gmmtril").builder(torch.from_numpy(raw), (3,))
  want = jparse("gmmtril").builder(jnp.asarray(raw), (3,))
  x = rs.randn(2, 3).astype(np.float32)
  close(got.log_prob(torch.from_numpy(x)), want.log_prob(jnp.asarray(x)),
        what="gmmtril log_prob")
  tril = np.tril(rs.randn(2, 3, 3)).astype(np.float32)
  tril[:, range(3), range(3)] = np.abs(tril[:, range(3), range(3)]) + 0.5
  logits, locs = rs.randn(2).astype(np.float32), rs.randn(2, 3).astype(
      np.float32)
  got = PD.GaussianMixture(torch.from_numpy(logits), torch.from_numpy(locs),
                           torch.from_numpy(tril), "tril")
  want = JD.GaussianMixture(jnp.asarray(logits), jnp.asarray(locs),
                            jnp.asarray(tril), "tril")
  close(got.log_prob(torch.from_numpy(x)), want.log_prob(jnp.asarray(x)),
        what="GaussianMixture log_prob")
  close(got.variance(), want.variance(), what="variance")


ALIASES = [("qlogistic", (4, 4, 3), {}),
           ("quantizedlogistic", (2, 3), {}),
           ("mixqlogistic", (4, 4, 3), dict(n_components=10)),
           ("mixqlogist", (5,), dict(n_components=3)),
           ("gmmdiag", (3,), dict(n_components=4)),
           ("mdn", (2,), {})]


@pytest.mark.parametrize("alias,event_shape,kw", ALIASES,
                         ids=[a[0] for a in ALIASES])
def test_image_aliases_match_jax(alias, event_shape, kw):
  """Each alias's params_size and the distribution its builder makes of
  the same raw params: log_prob of data, the mean, and the log_prob's
  gradient in the raw params."""
  d = int(np.prod(event_shape))
  n = jparse(alias).params_size(d, **kw)
  assert pparse(alias).params_size(d, **kw) == n
  rs = np.random.RandomState(14)
  params = rs.randn(3, n).astype(np.float32)
  if alias.startswith(("gmm", "mdn")):
    x = rs.randn(3, *event_shape).astype(np.float32)
  else:
    x = (rs.randint(0, 256, (3,) + event_shape) / 255.0).astype(np.float32)
  jfn = lambda p: jparse(alias).builder(p, event_shape, **kw).log_prob(x)
  pfn = lambda p: pparse(alias).builder(p, event_shape, **kw).log_prob(
      torch.from_numpy(x))
  close(pfn(torch.from_numpy(params)), jfn(params), what="log_prob")
  close(pparse(alias).builder(torch.from_numpy(params), event_shape,
                              **kw).mean(),
        jparse(alias).builder(params, event_shape, **kw).mean(), what="mean")
  (jg,), (pg,) = _grads(jfn, pfn, params)
  close(pg, jg, GRAD_RTOL, GRAD_RTOL * float(np.abs(jg).max()))
