"""The port's distribution-alias registry against the JAX package's: the
same set of names, and for each name the same ``params_size``, the same
family built from the same raw parameters (``log_prob`` of a value in its
support and its mean, within 1e-5 of their largest magnitude) and the
same default prior.  ``mvntril`` is checked on a raw vector whose
lower-triangular fill order matters (no symmetry to hide a transposed
fill)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from odin_tpu.bay.distribution_alias import _ALIASES as JAX_ALIASES
from odin_tpu.bay.distribution_alias import parse_distribution as jparse
from odin_tpu_torch.bay.distribution_alias import _ALIASES as PORT_ALIASES
from odin_tpu_torch.bay.distribution_alias import parse_distribution as pparse

RTOL = 1e-5
EVENT = (3,)
COUNTS = {"poisson", "zipoisson", "nb", "zinb", "nbd", "zinbd", "mixnb",
          "mixzinb"}
KWARGS = {"binomial": dict(total_count=4.0),
          "multinomial": dict(total_count=5.0),
          "dirimultinomial": dict(total_count=5.0),
          "gmmdiag": dict(n_components=3), "gmmtril": dict(n_components=3),
          "mixnb": dict(n_components=3), "mixzinb": dict(n_components=3),
          "mixqlogistic": dict(n_components=4)}


def close(got, want, what=""):
  g, w = got.detach().numpy(), np.asarray(want)
  assert g.shape == w.shape, (what, g.shape, w.shape)
  np.testing.assert_allclose(g, w, rtol=RTOL,
                             atol=RTOL * max(float(np.abs(w).max()), 1e-30),
                             err_msg=what)


def value_for(spec_name, jd, rs):
  """A value in the support of the JAX distribution `jd` (batch 4)."""
  if spec_name == "categorical":
    return rs.randint(0, 3, 4).astype(np.int32)
  if spec_name in ("onehot", "relaxedonehot"):
    v = rs.dirichlet(np.ones(3), 4).astype(np.float32)
    return (v == v.max(-1, keepdims=True)).astype(np.float32) \
        if spec_name == "onehot" else v
  if spec_name in COUNTS:
    x = rs.poisson(2.0, (4,) + EVENT).astype(np.float32)
    x[rs.rand(*x.shape) < 0.4] = 0
    return x
  if spec_name == "binomial":
    return rs.randint(0, 5, (4,) + EVENT).astype(np.float32)
  if spec_name in ("multinomial", "dirimultinomial"):
    return rs.multinomial(5, [0.2, 0.5, 0.3], 4).astype(np.float32)
  if spec_name in ("bernoulli", "zibernoulli"):
    return (rs.rand(4, *EVENT) < 0.5).astype(np.float32)
  if spec_name in ("cbernoulli", "beta", "relaxedbernoulli"):
    return rs.uniform(0.05, 0.95, (4,) + EVENT).astype(np.float32)
  if spec_name in ("lognormal", "gamma"):
    return rs.uniform(0.2, 3.0, (4,) + EVENT).astype(np.float32)
  if spec_name == "dirichlet":
    return rs.dirichlet(np.ones(3), 4).astype(np.float32)
  if spec_name in ("qlogistic", "mixqlogistic"):
    return rs.randint(0, 256, (4,) + EVENT).astype(np.float32)
  if spec_name in ("vmf", "powerspherical"):
    v = rs.randn(4, 3)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
  if spec_name in ("deterministic", "vdeterministic"):
    return np.array(jd.mean())
  return rs.randn(4, *EVENT).astype(np.float32)


def test_alias_sets_are_equal():
  assert set(PORT_ALIASES) == set(JAX_ALIASES)
  for name in JAX_ALIASES:
    assert pparse(name).name == jparse(name).name, name


@pytest.mark.parametrize("alias", sorted(JAX_ALIASES))
def test_alias_builds_and_scores_as_jax(alias):
  js, ps = jparse(alias), pparse(alias)
  kw = KWARGS.get(js.name, {})
  n = js.params_size(EVENT[0], **kw)
  assert ps.params_size(EVENT[0], **kw) == n
  rs = np.random.RandomState(sorted(JAX_ALIASES).index(alias))
  raw = rs.randn(4, n).astype(np.float32)
  jd = js.builder(jnp.asarray(raw), EVENT, **kw)
  pd = ps.builder(torch.from_numpy(raw), EVENT, **kw)
  assert type(pd).__name__ == type(jd).__name__
  assert tuple(pd.batch_shape) == tuple(jd.batch_shape)
  assert tuple(pd.event_shape) == tuple(jd.event_shape)
  x = value_for(js.name, jd, rs)
  close(pd.log_prob(torch.from_numpy(x)), jd.log_prob(jnp.asarray(x)),
        "log_prob")
  if js.name != "categorical":
    close(pd.mean(), jd.mean(), "mean")
  jp, pp = js.default_prior(EVENT, **kw), ps.default_prior(EVENT, **kw)
  assert (jp is None) == (pp is None)
  if jp is not None:
    assert type(pp).__name__ == type(jp).__name__
    assert tuple(pp.event_shape) == tuple(jp.event_shape)


def test_mvntril_fills_rows_in_tril_order():
  d = 4
  raw = np.arange(1, d + d * (d + 1) // 2 + 1, dtype=np.float32) / 10.0
  jd = jparse("mvntril").builder(jnp.asarray(raw), (d,))
  pd = pparse("mvntril").builder(torch.from_numpy(raw), (d,))
  close(pd.scale_tril, jd.scale_tril, "scale_tril")
  L = pd.scale_tril.numpy()
  rows, cols = np.tril_indices(d)
  off = rows != cols
  np.testing.assert_array_equal(L[rows[off], cols[off]], raw[d:][off])
  assert np.all(np.triu(L, 1) == 0)
  x = np.linspace(-1, 1, d).astype(np.float32)
  close(pd.log_prob(torch.from_numpy(x)), jd.log_prob(jnp.asarray(x)),
        "log_prob")
