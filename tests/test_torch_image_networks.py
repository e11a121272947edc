"""The port's image networks (``odin_tpu_torch/networks/image_networks.py``)
and the layers they add (``SpaceToDepthConv``, the subpixel
``ConvTranspose``, ``SkipSequential``, ``LogNorm``, ``Dropout``, the
factories and ``NetConf``) against the JAX package's.

* every name of JAX's ``get_networks`` but the gene sets': the same
  heads, shapes and ``hierarchy``, and the port's parameter tree, through
  the weight bridge, equal in paths and shapes to the JAX model's own init
  (``jax.eval_shape``);
* the variants (resnet, skip-generator, space-to-depth, the Gaussian and
  quantized-logistic heads): the ELBO terms on the same params, batch and
  JAX's recorded noise (rtol 1e-5 of each term's largest magnitude);
* the exact rewrites, against the port's plain layers and JAX's;
* ``get_optimizer_info``'s values;
* one ``BetaVAE`` step on ``cifar10_networks`` and on ``mnist_networks``:
  the loss at rtol 1e-5 and every parameter's gradient within 1e-4 of
  that tensor's largest value.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odin_tpu.networks.base as JB
import odin_tpu.networks.image_networks as JN
import odin_tpu_torch.networks.base as PB
import odin_tpu_torch.networks.image_networks as PN
from odin_tpu_torch.training.core import Noise
from odin_tpu_torch.weights import from_jax_params, to_jax_params
from torch_zoo_common import (assert_tree_matches_jax_init, elbo_matches_jax,
                              jit_with_draws, make_pair, to_torch)

RTOL, GRAD_TOL = 1e-5, 1e-4
NAMES = sorted(n.split("_")[0] for n in JN.__all__
               if n.endswith("_networks") and n not in (
                   "cortex_networks", "pbmc_networks", "get_networks")) + [
                       "halfmnist"]


def pixels(shape, n=2, seed=0):
  """n images of `shape` on the 8-bit grid, in [0, 1]."""
  return (np.random.RandomState(seed).randint(0, 256, (n,) + tuple(shape))
          / 255.0).astype(np.float32)


def both(name, **kw):
  return PN.get_networks(name, **kw), JN.get_networks(name, **kw)


def _rv(rv):
  return (tuple(rv.event_shape), rv.posterior, rv.projection, rv.name)


@pytest.mark.parametrize("name", NAMES)
def test_get_networks_matches_jax(name):
  """Each name's heads and hierarchy, semi-supervised too, and the
  BetaVAE's parameter tree against JAX's init."""
  for semi in (False, True):
    nets, jnets = both(name, is_semi_supervised=semi)
    assert set(nets) == set(jnets)
    assert nets["input_shape"] == tuple(jnets["input_shape"])
    assert tuple(nets.get("hierarchy", ())) == tuple(
        jnets.get("hierarchy", ()))
    for head in ("latents", "labels"):
      if jnets.get(head) is not None:
        assert _rv(nets[head]) == _rv(jnets[head])
    obs, jobs = nets["observation"], jnets["observation"]
    assert (obs.posterior, obs.params_size, obs.event_shape) == (
        jobs.posterior, jobs.params_size, tuple(jobs.event_shape))
  if name in ("vq", "halfmoons"):
    return
  nets, jnets = both(name)
  jvae, vae = make_pair("BetaVAE", networks=nets, jax_networks=jnets,
                        beta=1.0)
  x = pixels(vae.input_shape, n=1)
  assert_tree_matches_jax_init(jvae, vae, x)


VARIANTS = [("cifar10", {}), ("cifar10", dict(resnet=True)),
            ("cifar10", dict(distribution="gaussian")),
            ("cifar10", dict(skip_generator=True)),
            ("mnist", dict(skip_generator=True)),
            ("mnist", dict(distribution="qlogistic")),
            ("dsprites", dict(space_to_depth=True)),
            ("celeba", {})]


@pytest.mark.parametrize("name,kw", VARIANTS,
                         ids=[f"{n}-{'-'.join(k) or 'plain'}"
                              for n, k in VARIANTS])
def test_variant_elbo_matches_jax(name, kw):
  nets, jnets = both(name, **kw)
  pair = make_pair("BetaVAE", networks=nets, jax_networks=jnets, beta=1.0)
  elbo_matches_jax(pair, pixels(pair[1].input_shape), steps=(0,))


@pytest.mark.parametrize("name,kw", VARIANTS[1:-1],
                         ids=[f"{n}-{'-'.join(k)}" for n, k in VARIANTS[1:-1]])
def test_variant_tree_matches_jax(name, kw):
  nets, jnets = both(name, **kw)
  jvae, vae = make_pair("BetaVAE", networks=nets, jax_networks=jnets,
                        beta=1.0)
  assert_tree_matches_jax_init(jvae, vae, pixels(vae.input_shape, n=1))


def _jax_pixelcnn_networks(n_components):
  """The JAX package's modules wired as ``chip_smoke.pixelcnn_networks``:
  a PixelCNN decoder whose 3K maps a channel are packed into the
  'mixqlogistic' head's flat params."""
  from odin_tpu.bay.random_variable import RVconf
  from odin_tpu.networks.resnets import PixelCNNDecoder

  def pack(x):
    b, h, w, ck = x.shape
    k = ck // 9
    g = x.reshape(b, h, w, 3 * k, 3)
    maps = lambda i: g[..., i * k:(i + 1) * k, :].transpose(
        0, 3, 1, 2, 4).reshape(b, -1)
    return jnp.concatenate([g[..., :k, :].mean(axis=(1, 2, 4)), maps(1),
                            maps(2)], -1)

  nets = JN.get_networks("cifar10")
  nets["decoder"] = JB.SequentialNetwork(
      (PixelCNNDecoder((32, 32, 3), 32, 4, 3 * n_components),
       JB.Lambda(pack)), name="decoder")
  nets["observation"] = RVconf(
      (32, 32, 3), "mixqlogistic", projection=False, name="image",
      kwargs=dict(n_components=n_components)).create_posterior()
  return nets


def test_pixelcnn_mixture_head_matches_jax():
  """The PixelCNN decoder with the 10-component 'mixqlogistic' head of
  ``chip_smoke.py`` phase 19: the parameter tree and the ELBO terms."""
  import chip_smoke
  nets = chip_smoke.pixelcnn_networks(torch, n_components=10)
  pair = make_pair("BetaVAE", networks=nets,
                   jax_networks=_jax_pixelcnn_networks(10), beta=1.0)
  x = pixels((32, 32, 3))
  assert_tree_matches_jax_init(*pair, x[:1])
  elbo_matches_jax(pair, x, steps=(0,))


def test_obs_distribution_heads():
  """1 map for Bernoulli, 2 for the Gaussian and the quantized logistic,
  the alias's params_size for others; a mixture raises as in JAX."""
  for dist, n in [("bernoulli", 1), ("gaussian", 2), ("normal", 2),
                  ("qlogistic", 2), ("quantizedlogistic", 2)]:
    got, head = PN._obs_distribution((4, 4, 3), dist)
    want, jhead = JN._obs_distribution((4, 4, 3), dist)
    assert got == want == n and head.name == "image"
    assert head.params_size == jhead.params_size
  got, _ = PN._obs_distribution((4, 4, 3), "onehot")
  assert got == JN._obs_distribution((4, 4, 3), "onehot")[0]
  for dist in ("mixqlogistic", "mixqlogist"):
    with pytest.raises(NotImplementedError, match="PixelCNN"):
      PN._obs_distribution((4, 4, 3), dist)


def test_unported_names_raise():
  """An unknown name raises in both packages; the gene sets' networks
  (cortex, pbmc) are JAX's (tests/test_torch_gene_vae.py runs them)."""
  with pytest.raises(ValueError):
    PN.get_networks("nosuchset")
  with pytest.raises(ValueError):
    JN.get_networks("nosuchset")
  for name, genes, types in (("cortex", 558, 7), ("pbmc", 1000, 4)):
    for semi in (False, True):
      got = PN.get_networks(name, is_semi_supervised=semi)
      want = JN.get_networks(name, is_semi_supervised=semi)
      assert set(got) == set(want)
      assert got["input_shape"] == want["input_shape"] == (genes,)
      fields = ("event_shape", "posterior", "projection", "autoregressive",
                "dropout", "name", "prior", "kwargs")
      for head in ("latents", "observation", "labels"):
        if head in want:
          assert [getattr(got[head], f) for f in fields] == \
              [getattr(want[head], f) for f in fields], head
      if semi:
        assert got["labels"].event_shape == (types,)
      assert got["observation"].posterior == "zinbd"
      assert [type(l).__name__ for l in got["encoder"].layers] == \
          [type(l).__name__ for l in want["encoder"].layers]
      assert [type(l).__name__ for l in got["decoder"].layers] == \
          [type(l).__name__ for l in want["decoder"].layers]


# ---------------------------------------------------------------------------
# the exact rewrites
# ---------------------------------------------------------------------------
def _jax_apply(module, params, x):
  return np.asarray(module.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("channels,width", [(1, 32), (3, 64)])
def test_space_to_depth_equals_conv(channels, width):
  """``SpaceToDepthConv`` equals ``Conv(k4, s2)`` on the same params, the
  port's and JAX's, on dSprites' 64x64 inputs at full width and wider."""
  gen = torch.Generator().manual_seed(0)
  s2d = PB.SpaceToDepthConv(width, "elu")
  s2d.build((64, 64, channels), gen)
  conv = PB.Conv(width, 4, 2, "elu")
  conv.build((64, 64, channels))
  with torch.no_grad():
    s2d.bias.copy_(torch.randn(width, generator=gen))
    conv.load_state_dict(s2d.state_dict())
  x = np.random.RandomState(1).rand(2, 64, 64, channels).astype(np.float32)
  got = s2d(torch.from_numpy(x)).detach().numpy()
  np.testing.assert_allclose(got, conv(torch.from_numpy(x)).detach().numpy(),
                             rtol=RTOL, atol=1e-6)
  tree = to_jax_params(s2d)
  assert set(tree) == {"kernel", "bias"}
  np.testing.assert_allclose(
      got, _jax_apply(JB.SpaceToDepthConv(width, "elu"), tree, x), rtol=RTOL,
      atol=1e-6)
  np.testing.assert_allclose(
      got, _jax_apply(JB.Conv(width, 4, 2, "elu"), {"Conv_0": tree}, x),
      rtol=RTOL, atol=1e-6)
  assert set(from_jax_params(tree)) == {"weight", "bias"}


SUBPIXEL = [(4, 2, (4, 4, 64)), (5, 2, (7, 7, 16)), (3, 2, (5, 6, 3)),
            (8, 4, (3, 3, 4)), (3, 3, (4, 5, 2)), (2, 2, (4, 4, 3)),
            (4, 1, (4, 4, 3))]


@pytest.mark.parametrize("k,s,shape", SUBPIXEL,
                         ids=[f"k{k}s{s}" for k, s, _ in SUBPIXEL])
def test_subpixel_equals_conv_transpose(k, s, shape):
  """``ConvTranspose(subpixel=True)`` equals the plain one on the same
  params, and JAX's plain ``nn.ConvTranspose`` (JAX's subpixel form too);
  stride 1 keeps the plain form."""
  gen = torch.Generator().manual_seed(2)
  sub = PB.ConvTranspose(6, k, s, "relu", subpixel=True)
  sub.build(shape, gen)
  plain = PB.ConvTranspose(6, k, s, "relu")
  plain.build(shape)
  with torch.no_grad():
    sub.bias.copy_(torch.randn(6, generator=gen))
    plain.load_state_dict(sub.state_dict())
  assert sub.uses_subpixel == (s > 1)
  x = np.random.RandomState(3).randn(2, *shape).astype(np.float32)
  got = sub(torch.from_numpy(x)).detach().numpy()
  np.testing.assert_allclose(got, plain(torch.from_numpy(x)).detach().numpy(),
                             rtol=RTOL, atol=1e-5)
  tree = to_jax_params(sub)
  for flag in (False, True):
    np.testing.assert_allclose(
        got, _jax_apply(JB.ConvTranspose(6, k, s, "relu", subpixel=flag),
                        tree, x), rtol=RTOL, atol=1e-5)


def test_skip_generator_creates_jax_projections():
  """``SkipSequential`` makes ``skip_proj_{i}`` for the 4-d outputs only,
  and adds the projected input with an ELU, as JAX."""
  layers = lambda M: (M.Dense(32, None), M.Reshape((4, 4, 2)),
                      M.ConvTranspose(3, 3, 2, "elu"), M.Conv(2, 1, 1, None),
                      M.Flatten())
  port = PB.SkipSequential(layers(PB))
  port.build((5,), torch.Generator().manual_seed(4))
  tree = to_jax_params(port)
  assert sorted(k for k in tree if k.startswith("skip")) == [
      "skip_proj_1", "skip_proj_2", "skip_proj_3"]
  jmod = JB.SkipSequential(layers(JB))
  z = np.random.RandomState(5).randn(3, 5).astype(np.float32)
  init = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                          jnp.asarray(z)))["params"]
  shapes = lambda t: {jax.tree_util.keystr(k): np.shape(v) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
  assert shapes(tree) == shapes(init)
  np.testing.assert_allclose(port(torch.from_numpy(z)).detach().numpy(),
                             _jax_apply(jmod, tree, z), rtol=RTOL, atol=1e-6)


def test_lognorm_dropout_and_factories():
  x = np.random.RandomState(6).rand(4, 7).astype(np.float32) * 5
  np.testing.assert_allclose(
      PB.LogNorm()(torch.from_numpy(x)).numpy(),
      np.asarray(JB.LogNorm().apply({}, jnp.asarray(x))), rtol=RTOL)
  # Dropout: JAX's keep mask is a bernoulli, i.e. uniforms below 1 - rate
  drop = JB.Dropout(0.3)
  out, draws = jit_with_draws(lambda k: drop.apply(
      {}, jnp.asarray(x), training=True, rngs={"dropout": k}))(
          jax.random.PRNGKey(7))
  port = PB.Dropout(0.3).train()
  with PB.collecting_updates(Noise(eps=to_torch(draws))):
    got = port(torch.from_numpy(x))
  np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=RTOL)
  assert torch.equal(port.eval()(torch.from_numpy(x)), torch.from_numpy(x))
  with pytest.raises(RuntimeError):
    PB.Dropout(0.3).train()(torch.from_numpy(x))
  for conf in (dict(units=(8, 4), network="dense", batchnorm=True,
                    dropout=0.1, input_dropout=0.2),
               dict(units=(4, 6), network="conv", kernel=3, strides=2),
               dict(units=(5,), network="deconv", strides=2)):
    net = PB.NetConf(**conf).create_network()
    jnet = JB.NetConf(**conf).create_network()
    assert [type(l).__name__ for l in net.layers] == [
        type(l).__name__ for l in jnet.layers]
    dec = PB.NetConf(**conf).create_decoder_network((6, 6, 2))
    jdec = JB.NetConf(**conf).create_decoder_network((6, 6, 2))
    assert [type(l).__name__ for l in dec.layers] == [
        type(l).__name__ for l in jdec.layers]
  net = PB.NetConf(units=(6, 4), network="conv", strides=2).create_network()
  net.build((8, 8, 3), torch.Generator().manual_seed(8))
  jnet = JB.NetConf(units=(6, 4), network="conv", strides=2).create_network()
  xi = np.random.RandomState(9).randn(2, 8, 8, 3).astype(np.float32)
  np.testing.assert_allclose(net(torch.from_numpy(xi)).detach().numpy(),
                             _jax_apply(jnet, to_jax_params(net), xi),
                             rtol=RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# the optimizer budgets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["mnist", "binarizedmnist", "halfmnist",
                                  "fashionmnist", "omniglot", "svhn",
                                  "cifar10", "cifar100", "celeba",
                                  "celebasmall", "dsprites", "shapes3dsmall",
                                  "halfmoons"])
def test_optimizer_info_matches_jax(name):
  got = PN.get_optimizer_info(name, batch_size=32)
  want = JN.get_optimizer_info(name, batch_size=32)
  assert got["max_iter"] == want["max_iter"]
  for step in (0, 9999, 10000, 123456):
    np.testing.assert_allclose(float(got["learning_rate"](step)),
                               float(want["learning_rate"](step)), rtol=1e-6)


def test_optimizer_info_start_rates():
  assert float(PN.get_optimizer_info("cifar10")["learning_rate"](0)) == \
      pytest.approx(5e-4)
  assert float(PN.get_optimizer_info("celeba")["learning_rate"](0)) == \
      pytest.approx(2e-4)
  with pytest.raises(NotImplementedError):
    PN.get_optimizer_info("nosuchset")


# ---------------------------------------------------------------------------
# one BetaVAE step on the published widths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["cifar10", "mnist"])
def test_betavae_step_matches_jax(name):
  """The loss and every parameter's gradient of one training step on the
  same params, batch and JAX's recorded noise."""
  nets, jnets = both(name)
  jvae, vae = make_pair("BetaVAE", networks=nets, jax_networks=jnets,
                        beta=1.0)
  x = pixels(vae.input_shape, n=4, seed=10)

  def jloss(p):
    l, k = jvae.elbo_components(p, x, jax.random.PRNGKey(11), jnp.int32(0),
                                training=True, mutables={})[:2]
    return -jnp.mean(jvae.elbo(l, k))

  (jl, jg), draws = jit_with_draws(jax.value_and_grad(jloss))(
      jvae.state.params)
  params = {k: {n: v.detach().clone().requires_grad_(True)
                for n, v in part.items()}
            for k, part in vae.state.params.items()}
  l, k, _ = vae.elbo_components(params, torch.from_numpy(x),
                                Noise(eps=to_torch(draws)),
                                torch.tensor(0, dtype=torch.int32),
                                training=True, mutables={})
  loss = -vae.elbo(l, k).mean()
  loss.backward()
  np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
  want = from_jax_params(jax.device_get(jg)["vae"])
  got = params["vae"]
  assert set(want) == set(got)
  for n, w in want.items():
    w = w.numpy()
    np.testing.assert_allclose(got[n].grad.numpy(), w, rtol=GRAD_TOL,
                               atol=GRAD_TOL * float(np.abs(w).max()),
                               err_msg=n)
