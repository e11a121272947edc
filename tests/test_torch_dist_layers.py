"""The port's distribution heads and layers against the JAX package's on
the CPU, from carried weights (the port builds a layer, and the JAX module
is applied to ``to_jax_params`` of it; ``from_jax_params`` must give the
port's state back):

  * the heads of ``bay/layers/dense_distribution.py`` (the mixture heads,
    ``DenseDeterministic``, the latent shortcuts, ``merge_normal``/
    ``MergeNormal``, ``DistributionNetwork``), the generated per-family
    layer classes (the same names, aliases and defaults), the utility
    layers and the stochastic initializers;
  * ``AutoregressiveDense``: its MADE masks bitwise JAX's, the output
    within 1e-5, and each output unit of event dim i blind to inputs of
    degree i + 1 or more (a Jacobian);
  * ``RVconf(autoregressive=..., dropout=...)``: the head it makes, and
    the dropout drawing JAX's uniforms in training mode.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odin_tpu.bay.layers as JL
import odin_tpu_torch.bay.layers as PL
from odin_tpu.bay import stochastic_initializers as JS
from odin_tpu.bay.random_variable import RVconf as JaxRVconf
from odin_tpu_torch.bay import stochastic_initializers as PS
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.networks.base import collecting_updates
from odin_tpu_torch.training.core import Noise
from odin_tpu_torch.weights import from_jax_params, to_jax_params
from torch_zoo_common import jit_with_draws, to_torch

RTOL = 1e-5


def close(got, want, rtol=RTOL, what=""):
  g = got.detach().numpy() if isinstance(got, torch.Tensor) else \
      np.asarray(got)
  w = np.asarray(want)
  assert g.shape == w.shape, (what, g.shape, w.shape)
  np.testing.assert_allclose(g, w, rtol=rtol,
                             atol=rtol * max(float(np.abs(w).max()), 1e-30),
                             err_msg=what)


def carried(port, in_shape, seed=0):
  """Build the port's `port` on `in_shape` and return its flax params,
  checking that the bridge inverts."""
  port.build(in_shape, torch.Generator().manual_seed(seed))
  params = to_jax_params(port)
  back = from_jax_params(params)
  sd = port.state_dict()
  assert set(back) == set(sd)
  for k, v in back.items():
    assert torch.equal(v, sd[k]), k
  return params


def dists_close(pd, jd, x, what):
  close(pd.log_prob(torch.from_numpy(x)), jd.log_prob(jnp.asarray(x)),
        what=f"{what} log_prob")
  close(pd.mean(), jd.mean(), what=f"{what} mean")


HEADS = [
    ("MixtureDensityNetwork", dict(units=3, n_components=4,
                                   covariance="diag"), "create"),
    ("MixtureDensityNetwork", dict(units=3, n_components=2,
                                   covariance="tril"), "create"),
    ("MixtureMassNetwork", dict(units=5, n_components=3), "create"),
    ("MixtureMassNetwork", dict(units=5, n_components=2,
                                zero_inflated=True), "create"),
    ("DenseDeterministic", dict(event_shape=(4,)), None),
    ("NormalLatents", dict(event_shape=(4,)), None),
    ("MVNDiagLatents", dict(event_shape=(4,)), None),
    ("MixtureNormalLatents", dict(units=4, n_components=2), "create"),
    ("MixtureMVNDiagLatents", dict(units=4, n_components=3), "create"),
]


@pytest.mark.parametrize("cls,kw,ctor", HEADS,
                         ids=[f"{h[0]}-{i}" for i, h in enumerate(HEADS)])
def test_heads_match_jax(cls, kw, ctor):
  make = lambda L: getattr(getattr(L, cls), ctor)(**kw) if ctor \
      else getattr(L, cls)(**kw)
  port, jhead = make(PL), make(JL)
  assert port.posterior == jhead.posterior
  assert port.params_size == jhead.params_size
  rs = np.random.RandomState(len(cls))
  h = rs.randn(6, 7).astype(np.float32)
  params = carried(port, (7,))
  jd = jhead.apply({"params": params}, jnp.asarray(h))
  pd = port(torch.from_numpy(h))
  x = np.array(jd.mean())
  if "Mass" in cls:
    x = np.round(np.abs(x))
    x[:, ::2] = 0
  dists_close(pd, jd, x, cls)


def test_layer_classes_match_jax():
  from odin_tpu.bay.layers import distribution_layers as JDL
  from odin_tpu_torch.bay.layers import distribution_layers as PDL
  assert PDL.__all__ == JDL.__all__
  assert PDL._LAYER_ALIASES == JDL._LAYER_ALIASES
  rs = np.random.RandomState(1)
  for name in JDL.__all__:
    j, p = getattr(JDL, name)(event_shape=(3,)), getattr(PDL, name)(
        event_shape=(3,))
    assert type(p).__name__ == name
    assert p.posterior == j.posterior and p.projection is None
    assert not j.projection
    kw = {"n_components": 2} if "Mixture" in name else {}
    if kw:
      j, p = (getattr(JDL, name)(event_shape=(3,), posterior_kwargs=kw),
              getattr(PDL, name)(event_shape=(3,), posterior_kwargs=kw))
    raw = rs.randn(4, p.params_size).astype(np.float32)
    jd = j.apply({}, jnp.asarray(raw))
    pd = p(torch.from_numpy(raw))
    assert type(pd).__name__ == type(jd).__name__, name
  # projection=True prepends the Dense
  p = PDL.PoissonLayer((3,), projection=True)
  params = carried(p, (5,))
  j = JDL.PoissonLayer(event_shape=(3,), projection=True)
  h = rs.randn(2, 5).astype(np.float32)
  x = rs.poisson(2.0, (2, 3)).astype(np.float32)
  dists_close(p(torch.from_numpy(h)),
              j.apply({"params": params}, jnp.asarray(h)), x, "PoissonLayer")


def test_autoregressive_masks_and_output_match_jax():
  from odin_tpu.bay.layers.autoregressive import AutoregressiveDense as JAR
  from odin_tpu.bay.layers.autoregressive import _degrees as jdeg
  from odin_tpu_torch.bay.layers.autoregressive import (AutoregressiveDense,
                                                        _degrees, made_masks)
  for n, e, inp in ((7, 4, True), (9, 4, False), (5, 1, False),
                    (12, 5, True)):
    np.testing.assert_array_equal(_degrees(n, e, inp), jdeg(n, e, inp))
  E, P, n_in = 4, 2, 6
  port = AutoregressiveDense(params=P, event_size=E, hidden_units=(8, 5))
  params = carried(port, (n_in,))
  masks = made_masks(n_in, E, (8, 5), P)
  for name, m in zip(("0", "1", "out"), masks):
    assert torch.equal(getattr(port, f"mask_{name}"), torch.from_numpy(m))
  # JAX's masks, as its module forms them
  deg = jdeg(n_in, E, True)
  for width, m in zip((8, 5), masks[:2]):
    d2 = jdeg(width, E, False)
    np.testing.assert_array_equal(m, (deg[:, None] <= d2[None]).astype(
        np.float32))
    deg = d2
  out = np.tile((deg[:, None] < np.arange(1, E + 1)[None]).astype(
      np.float32), (1, P))
  np.testing.assert_array_equal(masks[2], out)
  x = np.random.RandomState(2).randn(3, n_in).astype(np.float32)
  want = JAR(params=P, event_size=E, hidden_units=(8, 5)).apply(
      {"params": params}, jnp.asarray(x))
  close(port(torch.from_numpy(x)), want, what="output")
  # event dim i's parameters see only inputs of degree < i + 1
  jac = torch.autograd.functional.jacobian(
      lambda v: port(v[None])[0], torch.from_numpy(x[0]))
  deg_in = _degrees(n_in, E, True)
  for p in range(P):
    for i in range(E):
      blind = deg_in >= i + 1
      assert torch.all(jac[p * E + i][torch.from_numpy(blind)] == 0)


@pytest.mark.parametrize("kw", [dict(autoregressive=True),
                                dict(dropout=0.25),
                                dict(autoregressive=True, dropout=0.1)])
def test_rvconf_autoregressive_and_dropout_heads_match_jax(kw):
  conf, jconf = RVconf((4,), "mvndiag", **kw), JaxRVconf((4,), "mvndiag",
                                                         **kw)
  port, jhead = conf.create_posterior(), jconf.create_posterior()
  assert port.autoregressive == jhead.autoregressive
  assert port.dropout == jhead.dropout
  params = carried(port, (6,))
  h = np.random.RandomState(3).randn(5, 6).astype(np.float32)
  x = np.random.RandomState(4).randn(5, 4).astype(np.float32)
  port.eval()
  dists_close(port(torch.from_numpy(h)),
              jhead.apply({"params": params}, jnp.asarray(h)), x, "eval")
  # training mode: JAX's dropout uniforms replayed
  fn = jit_with_draws(lambda p, v, k: jhead.apply(
      {"params": p}, v, training=True, rngs={"dropout": k}).mean())
  want, draws = fn(params, jnp.asarray(h), jax.random.PRNGKey(1))
  assert len(draws) == (1 if kw.get("dropout") else 0)
  port.train()
  with collecting_updates(Noise(eps=to_torch(draws))):
    got = port(torch.from_numpy(h)).mean()
  close(got, want, what="training")


def test_merge_normal_and_distribution_network_match_jax():
  from odin_tpu.bay.distributions import Normal as JN
  from odin_tpu_torch.bay.distributions import Normal as PN
  rs = np.random.RandomState(5)
  a = [rs.randn(3, 4).astype(np.float32), (np.abs(rs.randn(3, 4)) + .2
                                            ).astype(np.float32)]
  b = [rs.randn(3, 4).astype(np.float32), (np.abs(rs.randn(3, 4)) + .2
                                            ).astype(np.float32)]
  jm = JL.dense_distribution.merge_normal(JN(*map(jnp.asarray, a)),
                                          JN(*map(jnp.asarray, b)))
  pm = PL.MergeNormal()((PN(*map(torch.from_numpy, a)),
                         PN(*map(torch.from_numpy, b))))
  close(pm.loc, jm.loc, what="loc")
  close(pm.scale, jm.scale, what="scale")
  from odin_tpu.networks.base import Dense as JDense
  from odin_tpu.networks.base import SequentialNetwork as JSeq
  from odin_tpu_torch.networks.base import Dense, SequentialNetwork
  port = PL.DistributionNetwork(
      SequentialNetwork([Dense(8, "relu")]),
      [PL.NormalLatents((3,)), PL.MixtureMassNetwork.create(2)])
  params = carried(port, (5,))
  jnet = JL.dense_distribution.DistributionNetwork(
      network=JSeq((JDense(8, "relu"),)),
      distributions=(JL.NormalLatents(event_shape=(3,)),
                     JL.MixtureMassNetwork.create(2)))
  h = rs.randn(4, 5).astype(np.float32)
  jd = jnet.apply({"params": params}, jnp.asarray(h))
  pd = port(torch.from_numpy(h))
  dists_close(pd[0], jd[0], rs.randn(4, 3).astype(np.float32), "normal")
  dists_close(pd[1], jd[1], rs.poisson(2, (4, 2)).astype(np.float32),
              "mixnb")


def test_util_layers_match_jax():
  from odin_tpu.bay.distributions import MultivariateNormalDiag as JM
  from odin_tpu_torch.bay.distributions import MultivariateNormalDiag as PM
  rs = np.random.RandomState(6)
  loc = rs.randn(3, 4).astype(np.float32)
  scale = (np.abs(rs.randn(3, 4)) + .2).astype(np.float32)
  jd, pd = JM(jnp.asarray(loc), jnp.asarray(scale)), PM(
      torch.from_numpy(loc), torch.from_numpy(scale))
  jm, jv = JL.Moments().apply({}, jd)
  pm, pv = PL.Moments()(pd)
  close(pm, jm)
  close(pv, jv)
  close(PL.Moments(variance=False)(pd), JL.Moments(variance=False).apply(
      {}, jd))
  close(PL.Stddev()(pd), JL.Stddev().apply({}, jd))
  close(PL.DistributionAttr("scale_diag")(pd),
        JL.DistributionAttr("scale_diag").apply({}, jd))
  close(PL.DistributionAttr("mean")(pd), JL.DistributionAttr("mean").apply(
      {}, jd))
  t = torch.from_numpy(loc)
  assert torch.equal(PL.Moments()(t), t) and torch.equal(PL.Stddev()(t), t)
  sample, draws = jit_with_draws(lambda k: JL.Sampling((2,)).apply(
      {}, jd, rngs={"sample": k}))(jax.random.PRNGKey(2))
  with collecting_updates(Noise(eps=to_torch(draws))):
    close(PL.Sampling((2,))(pd), sample, what="sample")
  assert tuple(PL.Sampling((2, 2))(t).shape) == tuple(
      JL.Sampling((2, 2)).apply({}, jnp.asarray(loc)).shape) == (1, 1, 3, 4)
  got = PL.Sampling((5,), torch.Generator().manual_seed(0))(pd)
  assert got.shape == (5, 3, 4)
  y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 3)]
  jc = JL.ConditionalTensorLayer().apply({}, (jd, jnp.asarray(y)))
  pc = PL.ConditionalTensorLayer()((pd, torch.from_numpy(y)))
  close(pc.mean(), jc.mean())
  x = rs.randn(3, 6).astype(np.float32)
  close(pc.log_prob(torch.from_numpy(x)), jc.log_prob(jnp.asarray(x)))


@pytest.mark.parametrize("cls", ["TrainableNormal",
                                 "TrainableNormalSharedScale"])
def test_trainable_normal_matches_jax(cls):
  port = getattr(PS, cls)(shape=(3, 4))
  params = carried(port, None)
  jmod = getattr(JS, cls)(shape=(3, 4))
  jd = jmod.apply({"params": params}, method=jmod.distribution)
  pd = port()
  x = np.random.RandomState(7).randn(3, 4).astype(np.float32)
  dists_close(pd, jd, x, cls)
  close(pd.stddev(), jd.stddev())
  assert port.scale.shape == ((() if "Shared" in cls else (3, 4)))
  init = PS.trainable_normal_init(1.0, 0.5)(torch.Generator().manual_seed(0),
                                            (2000,))
  assert abs(float(init.mean()) - 1.0) < 0.05
  assert abs(float(init.std()) - 0.5) < 0.05


def test_variational_dense_matches_jax():
  port = PS.VariationalDense(5, prior_scale=0.7)
  params = carried(port, (6,))
  jmod = JS.VariationalDense(5, prior_scale=0.7)
  x = np.random.RandomState(8).randn(4, 6).astype(np.float32)
  want, state = jmod.apply({"params": params}, jnp.asarray(x),
                           mutable=["losses"])
  port.eval()
  close(port(torch.from_numpy(x)), want, what="eval")
  close(port.kernel_kl(), state["losses"]["kernel_kl"][0], what="kl")
  fn = jit_with_draws(lambda p, v, k: jmod.apply(
      {"params": p}, v, training=True, rngs={"sample": k},
      mutable=["losses"])[0])
  want, draws = fn(params, jnp.asarray(x), jax.random.PRNGKey(3))
  port.train()
  with collecting_updates(Noise(eps=to_torch(draws))):
    close(port(torch.from_numpy(x)), want, what="training")
