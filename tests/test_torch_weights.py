"""The flax -> torch weight bridge (odin_tpu_torch.weights), one test per
layout rule: each holds one flax layer of odin_tpu.networks and its port
layer, on the same weights and inputs, to atol 1e-5 (fp32 sums taken in a
different order).  Then whole training states of the zoo carried both
ways, exactly: extra params partitions, one optimizer state per name, and
the mutable collections (BatchNorm's batch_stats, a VQ codebook's
vq_stats)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from odin_tpu.networks import base as jb
from odin_tpu_torch.networks import base as tb
from odin_tpu_torch.weights import from_jax_params, to_jax_params

torch.set_num_threads(1)

ATOL = 1e-5


def _pair(jax_layer, port_layer, in_shape, seed=0):
  """Init the flax layer, carry its params into the port layer, and return
  both outputs on one seeded NHWC (or flat) batch of 2."""
  x = np.random.RandomState(seed).randn(2, *in_shape).astype(np.float32)
  params = jax_layer.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
  params = jax.device_get(params)
  port_layer.build(in_shape)
  port_layer.load_state_dict(from_jax_params(params), strict=True)
  want = np.asarray(jax_layer.apply({"params": params}, jnp.asarray(x)))
  with torch.no_grad():
    got = port_layer(torch.from_numpy(x)).numpy()
  return got, want, params, port_layer


def test_dense_kernel_is_transposed():
  got, want, params, layer = _pair(jb.Dense(7, "elu"), tb.Dense(7, "elu"), (5,))
  assert layer.weight.shape == (7, 5)
  np.testing.assert_array_equal(layer.weight.detach().numpy(),
                                params["Dense_0"]["kernel"].T)
  np.testing.assert_allclose(got, want, atol=ATOL)


def test_conv_hwio_becomes_oihw():
  got, want, params, layer = _pair(jb.Conv(6, 3, 1, "relu"),
                                   tb.Conv(6, 3, 1, "relu"), (9, 9, 4))
  assert layer.weight.shape == (6, 4, 3, 3)
  np.testing.assert_array_equal(
      layer.weight.detach().numpy(),
      params["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
  np.testing.assert_allclose(got, want, atol=ATOL)


def test_conv_transpose_kernel_is_flipped():
  """flax's ConvTranspose kernel is unflipped (kh, kw, in, out); the port's
  weight is (in, out, kh, kw) with both spatial axes flipped."""
  got, want, params, layer = _pair(jb.ConvTranspose(5, 3, 1),
                                   tb.ConvTranspose(5, 3, 1), (6, 6, 3))
  kernel = params["ConvTranspose_0"]["kernel"]
  assert layer.weight.shape == (3, 5, 3, 3)
  np.testing.assert_array_equal(
      layer.weight.detach().numpy(),
      kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
  np.testing.assert_allclose(got, want, atol=ATOL)
  # without the flip the layer computes something else
  with torch.no_grad():
    layer.weight.copy_(torch.from_numpy(
        np.ascontiguousarray(kernel.transpose(2, 3, 0, 1))))
    x = np.random.RandomState(0).randn(2, 6, 6, 3).astype(np.float32)
    assert np.abs(layer(torch.from_numpy(x)).numpy() - want).max() > 1e-2


@pytest.mark.parametrize("size", [8, 64, 7])
def test_same_padding_k4_s2_conv(size):
  """flax SAME at kernel 4, stride 2: symmetric padding 1 on even sizes
  (torch's padding=1), one more row and column at the end on odd ones."""
  got, want, _, layer = _pair(jb.Conv(3, 4, 2, "elu"), tb.Conv(3, 4, 2, "elu"),
                              (size, size, 2))
  assert got.shape == want.shape == (2, -(-size // 2), -(-size // 2), 3)
  np.testing.assert_allclose(got, want, atol=ATOL)
  if size % 2 == 0:
    assert tb.same_padding(size, 4, 2) == (1, 1)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, size, size, 2).astype(np.float32)).permute(0, 3, 1, 2)
    with torch.no_grad():
      explicit = torch.nn.functional.elu(torch.nn.functional.conv2d(
          x, layer.weight, layer.bias, 2, 1)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(explicit.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("size", [4, 8, 5])
def test_same_padding_k4_s2_conv_transpose(size):
  """flax SAME at kernel 4, stride 2 doubles the size; it equals torch's
  ConvTranspose2d(padding=1) on the flipped kernel."""
  got, want, _, layer = _pair(jb.ConvTranspose(3, 4, 2, "elu"),
                              tb.ConvTranspose(3, 4, 2, "elu"), (size, size, 2))
  assert got.shape == want.shape == (2, 2 * size, 2 * size, 3)
  np.testing.assert_allclose(got, want, atol=ATOL)
  assert tb.conv_transpose_padding(4, 2, "SAME") == (2, 2)
  x = torch.from_numpy(np.random.RandomState(0).randn(
      2, size, size, 2).astype(np.float32)).permute(0, 3, 1, 2)
  with torch.no_grad():
    explicit = torch.nn.functional.elu(torch.nn.functional.conv_transpose2d(
        x, layer.weight, layer.bias, 2, 1)).permute(0, 2, 3, 1)
  np.testing.assert_allclose(explicit.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("kernel,stride", [(3, 2), (1, 1), (5, 3)])
def test_same_padding_other_shapes(kernel, stride):
  """Asymmetric XLA padding: an end pad (conv) or an output pad or crop
  (transposed conv)."""
  for jax_cls, port_cls in ((jb.Conv, tb.Conv),
                            (jb.ConvTranspose, tb.ConvTranspose)):
    got, want, _, _ = _pair(jax_cls(4, kernel, stride),
                            port_cls(4, kernel, stride), (7, 6, 3))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_flatten_then_dense_keeps_nhwc_order():
  """Flatten reads NHWC, so the Dense kernel after it needs no permutation."""
  got, want, params, layer = _pair(
      jb.SequentialNetwork((jb.Flatten(), jb.Dense(6))),
      tb.SequentialNetwork([tb.Flatten(), tb.Dense(6)]), (4, 4, 3))
  assert set(params) == {"layers_1"}
  assert set(layer.state_dict()) == {"layers.1.weight", "layers.1.bias"}
  np.testing.assert_allclose(got, want, atol=ATOL)


def test_to_jax_params_inverts_from_jax_params():
  net = jb.SequentialNetwork((jb.Conv(4, 4, 2), jb.ConvTranspose(3, 4, 2),
                              jb.Flatten(), jb.Dense(5)))
  _, _, params, layer = _pair(
      net, tb.SequentialNetwork([tb.Conv(4, 4, 2), tb.ConvTranspose(3, 4, 2),
                                 tb.Flatten(), tb.Dense(5)]), (8, 8, 2))
  back = to_jax_params(layer)
  flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                    jax.tree_util.tree_flatten_with_path(t)[0]}
  want, got = flat(params), flat(back)
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _flat(tree):
  return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
          jax.tree_util.tree_flatten_with_path(tree)[0]}


def _mha_params(seed=0):
  from odin_tpu.networks.attention import MultiHeadAttention
  x = jnp.asarray(np.random.RandomState(seed).randn(2, 16, 32), jnp.float32)
  params = MultiHeadAttention(num_heads=4).init(jax.random.PRNGKey(seed),
                                                x)["params"]
  return jax.device_get(params)


def test_mha_qkv_kernels_flatten_the_heads():
  """query/key/value kernel (F_in, H, D_h) -> weight (H·D_h, F_in), bias
  (H, D_h) -> (H·D_h,); MultiHeadDotProductAttention_0 has no module."""
  params = _mha_params()
  sd = from_jax_params(params)
  mha = params["MultiHeadDotProductAttention_0"]
  for name in ("query", "key", "value"):
    kernel, bias = mha[name]["kernel"], mha[name]["bias"]
    assert kernel.shape == (32, 4, 8)
    np.testing.assert_array_equal(sd[f"{name}.weight"].numpy(),
                                  kernel.reshape(32, 32).T)
    np.testing.assert_array_equal(sd[f"{name}.bias"].numpy(),
                                  bias.reshape(32))


def test_mha_out_kernel_flattens_the_heads():
  """out kernel (H, D_h, F_out) -> weight (F_out, H·D_h); head h's rows of
  the flattened input are h·D_h .. (h + 1)·D_h - 1."""
  params = _mha_params(1)
  sd = from_jax_params(params)
  kernel = params["MultiHeadDotProductAttention_0"]["out"]["kernel"]
  assert kernel.shape == (4, 8, 32)
  w = sd["out.weight"].numpy()
  assert w.shape == (32, 32)
  np.testing.assert_array_equal(w[:, 8 * 2 + 5], kernel[2, 5])
  assert set(sd) == {f"{n}.{p}" for n in ("query", "key", "value", "out")
                     for p in ("weight", "bias")}


def test_attention_dense_params_keep_their_names():
  """Attention's own nn.Dense layers; flax's `position` is `position_proj`
  (the port's `position` names the mode); `v_add` stays a raw parameter."""
  from odin_tpu.networks.attention import Attention
  from odin_tpu_torch.networks.attention import Attention as PortAttention
  x = np.random.RandomState(2).randn(2, 5, 6).astype(np.float32)
  params = jax.device_get(Attention(
      units=4, score="additive", position="local_p").init(
          jax.random.PRNGKey(0), jnp.asarray(x))["params"])
  sd = from_jax_params(params)
  assert set(sd) == {f"{n}.{p}" for n in ("q_proj", "k_proj", "pos_hidden",
                                          "position_proj", "w_add", "u_add")
                     for p in ("weight", "bias")} | {"v_add"}
  np.testing.assert_array_equal(sd["v_add"].numpy(), params["v_add"])
  np.testing.assert_array_equal(sd["position_proj.weight"].numpy(),
                                params["position"]["kernel"].T)
  port = PortAttention(units=4, score="additive", position="local_p")
  port.build((5, 6))
  port.load_state_dict(sd, strict=True)


def test_attention_heads_projections_keep_their_names():
  from odin_tpu.networks.attention import AttentionHeads
  x = np.random.RandomState(3).randn(2, 5, 6).astype(np.float32)
  params = jax.device_get(AttentionHeads(num_heads=3, depth=2).init(
      jax.random.PRNGKey(0), jnp.asarray(x))["params"])
  sd = from_jax_params(params)
  assert sd["head_proj_0.weight"].shape == (18, 6)
  assert sd["head_proj_1.weight"].shape == (18, 18)


@pytest.mark.parametrize("which", ["mha", "attention", "heads", "nested"])
def test_to_jax_params_inverts_from_jax_params_for_attention(which):
  from odin_tpu.networks import attention as ja
  from odin_tpu_torch.networks import attention as ta
  x = jnp.asarray(np.random.RandomState(4).randn(2, 6, 8), jnp.float32)
  if which == "mha":
    jm, tm = ja.MultiHeadAttention(num_heads=2), ta.MultiHeadAttention(2)
  elif which == "attention":
    jm = ja.Attention(units=4, score="additive", position="local_p")
    tm = ta.Attention(units=4, score="additive", position="local_p")
  elif which == "heads":
    jm, tm = ja.AttentionHeads(num_heads=2, depth=2), ta.AttentionHeads(2, 2)
  else:  # an attention layer held by another module
    jm, tm = ja.SelfAttention(units=4, score="general"), \
        ta.SelfAttention(units=4, score="general")
  params = jax.device_get(jm.init(jax.random.PRNGKey(0), x)["params"])
  tm.build((6, 8), **({"device": "cpu"} if which == "mha" else {}))
  tm.load_state_dict(from_jax_params(params), strict=True)
  want, got = _flat(params), _flat(to_jax_params(tm))
  assert set(got) == set(want)
  for k in want:
    assert got[k].shape == want[k].shape, k
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_to_jax_params_follows_the_bare_flag_not_the_name():
  """A Dense built with bare=True is one of flax's own nn.Dense layers (no
  Dense_0), whatever its name; any other Dense holds its kernel under
  Dense_0, also where its name is one of the attention layers'."""
  m = torch.nn.Module()
  m.loc = tb.Dense(3)
  m.other = tb.Dense(3, bare=True)
  for layer in (m.loc, m.other):
    layer.build((4,))
  tree = to_jax_params(m)
  assert set(tree["loc"]) == {"Dense_0"}
  assert set(tree["other"]) == {"kernel", "bias"}
  m.load_state_dict(from_jax_params(tree), strict=True)


# ---------------------------------------------------------------------------
# the zoo's states: partitions, optimizers and mutables
# ---------------------------------------------------------------------------
def _states_equal(a, b):
  want, got = _flat(jax.device_get(a)), _flat(jax.device_get(b))
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_state_after_a_step(cls, **kwargs):
  from torch_zoo_common import B, binary_images, make_pair
  jvae, vae = make_pair(cls, **kwargs)
  step = jax.jit(jvae.make_step_fn(jit=False))
  js, _ = step(jvae.state, binary_images(2 * B, 0))
  return jvae, vae, jax.device_get(js)


@pytest.mark.parametrize("cls,kwargs,partitions,optimizers", [
    ("FactorVAE", dict(discriminator_units=(8,)), {"vae", "discriminator"},
     {"vae", "discriminator"}),
    ("VampriorVAE", dict(n_components=3), {"vae", "pseudo_inputs"},
     {"vae"}),
    ("TwoStageVAE", dict(stage2_units=8), {"vae", "stage2"},
     {"vae", "stage2"}),
    ("VQVAE", dict(n_codes=8, ema=True), {"vae"}, {"vae"}),
])
def test_zoo_state_round_trips_exactly(cls, kwargs, partitions, optimizers):
  """JAX -> port -> JAX is exact, and the port's state steps on."""
  from odin_tpu_torch.weights import from_jax_state, to_jax_state
  from torch_zoo_common import B, binary_images
  jvae, vae, js = _jax_state_after_a_step(cls, **kwargs)
  state = from_jax_state(js, device="cpu")
  assert set(state.params) == partitions
  assert set(state.opt_states) == optimizers
  if cls == "FactorVAE":  # the discriminator's Adam, its count and moments
    disc = state.opt_states["discriminator"]
    assert int(disc["count"]) == 1
    assert set(disc["mu"]) == {"discriminator"}
  if cls == "VQVAE":
    assert set(state.mutables) == {"vae"}
    assert set(state.mutables["vae"]) == {
        "latents.codebook", "latents.counts", "latents.means"}
  _states_equal(to_jax_state(state, js), js)
  vae.state = state
  s, m = vae.make_step_fn(keep_opt_states=True)(state, binary_images(2 * B, 1))
  assert int(s.step) == 2 and torch.isfinite(m[next(iter(m))])


def test_port_state_round_trips_through_jax():
  """port -> JAX -> port is exact for a state the port's step made, its
  EMA codebook included."""
  from odin_tpu_torch.weights import from_jax_state, to_jax_state
  from torch_zoo_common import B, binary_images
  jvae, vae, js = _jax_state_after_a_step("VQVAE", n_codes=8, ema=True)
  s, _ = vae.make_step_fn()(vae.state, binary_images(B, 2))
  back = from_jax_state(to_jax_state(s, js), device="cpu")
  for tree in ("params", "mutables"):
    got, want = getattr(back, tree), getattr(s, tree)
    assert set(got) == set(want)
    for p in want:
      assert set(got[p]) == set(want[p])
      for k in want[p]:
        torch.testing.assert_close(got[p][k], want[p][k], rtol=0, atol=0)
  assert int(back.opt_states["vae"]["count"]) == 1


def test_mutables_of_a_batchnorm_network_round_trip():
  from odin_tpu.bay.vi.autoencoder.factor_discriminator import (
      FactorDiscriminator as JaxDiscriminator)
  from odin_tpu_torch.bay.vi.autoencoder import FactorDiscriminator
  from odin_tpu_torch.weights import from_jax_mutables, to_jax_mutables
  jd = JaxDiscriminator(units=(6, 6), batchnorm=True)
  variables = jax.device_get(jd.init(jax.random.PRNGKey(0), jnp.ones((2, 3))))
  stats = {"batch_stats": jax.tree_util.tree_map(
      lambda a: a + np.arange(a.size, dtype=a.dtype).reshape(a.shape),
      variables["batch_stats"])}
  d = FactorDiscriminator(units=(6, 6), batchnorm=True)
  d.build((3,))
  d.load_state_dict({**from_jax_params(variables["params"]),
                     **from_jax_mutables(stats)}, strict=True)
  _states_equal(to_jax_mutables(d), stats)
  _states_equal(to_jax_params(d), variables["params"])


def test_lambda_layer_holds_no_params_and_matches_flax():
  net = jb.SequentialNetwork((jb.Dense(5), jb.Lambda(jnp.tanh), jb.Dense(3)))
  got, want, params, layer = _pair(
      net, tb.SequentialNetwork([tb.Dense(5), tb.Lambda(torch.tanh),
                                 tb.Dense(3)]), (4,))
  assert set(params) == {"layers_0", "layers_2"}
  assert list(layer.layers[1].parameters()) == []
  np.testing.assert_allclose(got, want, atol=ATOL)


def _image_blocks():
  """(JAX module, the port's module, input shape) of the natural-image
  slice's flax trees: residual stacks both ways, batch-normed bottleneck
  and inverted blocks, the PixelCNN decoder, the space-to-depth and
  subpixel rewrites, and the skip-generator decoder."""
  import odin_tpu.networks.resnets as jr
  import odin_tpu_torch.networks.resnets as tr
  from odin_tpu.networks.image_networks import get_networks as jnets
  from odin_tpu_torch.networks.image_networks import get_networks as tnets
  return {
      "residual_down": (jr.ResidualSequential((8, 8), strides=(2, 1),
                                              use_se=True),
                        tr.ResidualSequential((8, 8), strides=(2, 1),
                                              use_se=True), (4, 4, 3)),
      "residual_up": (jr.ResidualSequential((8, 4), strides=(-2, -2),
                                            use_se=True),
                      tr.ResidualSequential((8, 4), strides=(-2, -2),
                                            use_se=True), (2, 2, 2)),
      "bottleneck_bn": (jr.ResidualBottleneck(filters_out=6, strides=2),
                        tr.ResidualBottleneck(filters_out=6, strides=2),
                        (6, 6, 4)),
      "inverted_bn": (jr.ResidualInverted(), tr.ResidualInverted(),
                      (5, 5, 4)),
      "pixelcnn": (jr.PixelCNNDecoder((6, 6, 3), 8, 2, 6),
                   tr.PixelCNNDecoder((6, 6, 3), 8, 2, 6), (4,)),
      "space_to_depth": (jb.SpaceToDepthConv(8), tb.SpaceToDepthConv(8),
                         (8, 8, 2)),
      "subpixel": (jb.ConvTranspose(5, 4, 2, subpixel=True),
                   tb.ConvTranspose(5, 4, 2, subpixel=True), (4, 4, 3)),
      "up_sample": (jr.UpSample(4), tr.UpSample(4), (3, 3, 2)),
      "skip_decoder": (jnets("cifar10", zdim=6,
                             skip_generator=True)["decoder"],
                       tnets("cifar10", zdim=6,
                             skip_generator=True)["decoder"], (6,)),
  }


@pytest.mark.parametrize("name", ["residual_down", "residual_up",
                                  "bottleneck_bn", "inverted_bn", "pixelcnn",
                                  "space_to_depth", "subpixel", "up_sample",
                                  "skip_decoder"])
def test_image_slice_trees_round_trip(name):
  """JAX's own init of each new module -> the port's state dict (params
  and batch statistics; only a masked conv's fixed mask is left out) ->
  flax trees equal to JAX's.  Outputs are held in test_torch_resnets.py
  and test_torch_image_networks.py."""
  from odin_tpu_torch.weights import from_jax_mutables, to_jax_mutables
  jmod, tmod, shape = _image_blocks()[name]
  x = jnp.asarray(np.random.RandomState(0).randn(2, *shape), jnp.float32)
  variables = jax.device_get(jax.jit(jmod.init)(jax.random.PRNGKey(1), x))
  stats = {k: v for k, v in variables.items() if k != "params"}
  tmod.build(shape)
  tmod.load_state_dict({**from_jax_params(variables["params"]),
                        **from_jax_mutables(stats)}, strict=False)
  missing = set(tmod.state_dict()) - set(from_jax_params(
      variables["params"])) - set(from_jax_mutables(stats))
  assert all(k.endswith("mask") for k in missing), missing
  _states_equal(to_jax_params(tmod), variables["params"])
  _states_equal(to_jax_mutables(tmod), stats)


# ---------------------------------------------------------------------------
# the distribution heads and stochastic layers
# ---------------------------------------------------------------------------
def _heads(package):
  """name -> (module, input shape) of the layers with the new rules: a
  MADE head (its masked kernels), the mixture heads inside a
  DistributionNetwork (``distributions_<i>``), the stochastic
  initializers, and a ConditionalTensorLayer (no params)."""
  if package == "jax":
    import odin_tpu.bay.layers as L
    from odin_tpu.bay import stochastic_initializers as S
    net = lambda: jb.SequentialNetwork((jb.Dense(6, "relu"),))
    dn = lambda n, d: L.dense_distribution.DistributionNetwork(
        network=n, distributions=tuple(d))
    dd = lambda **kw: L.DistributionDense(**kw)
  else:
    import odin_tpu_torch.bay.layers as L
    from odin_tpu_torch.bay import stochastic_initializers as S
    net = lambda: tb.SequentialNetwork([tb.Dense(6, "relu")])
    dn = lambda n, d: L.DistributionNetwork(n, list(d))
    dd = lambda **kw: L.DistributionDense(**kw)
  return {
      "made": (dd(event_shape=(4,), posterior="mvndiag",
                  autoregressive=True), (5,)),
      "mixtures": (dn(net(), [L.MixtureDensityNetwork.create(
          3, 2, covariance="tril"), L.MixtureMassNetwork.create(
              4, 3, zero_inflated=True)]), (5,)),
      "variational": (S.VariationalDense(3), (5,)),
      "trainable": (S.TrainableNormal(shape=(2, 3)), None),
      "shared": (S.TrainableNormalSharedScale(shape=(4,)), None),
      "conditional": (L.ConditionalTensorLayer(), None),
  }


@pytest.mark.parametrize("name", ["made", "mixtures", "variational",
                                  "trainable", "shared", "conditional"])
def test_distribution_layers_round_trip(name):
  """flax's init -> ``from_jax_params`` loads the port's module strictly,
  ``to_jax_params`` gives flax's tree back exactly, and the outputs
  agree."""
  jmod, in_shape = _heads("jax")[name]
  pmod, _ = _heads("torch")[name]
  rng = jax.random.PRNGKey(3)
  x = np.random.RandomState(1).randn(2, *(in_shape or (1,))).astype(
      np.float32)
  if name == "conditional":
    assert pmod.build(None) is None and not list(pmod.parameters())
    return
  if in_shape is None:
    params = jmod.init(rng, method=jmod.distribution)["params"]
  else:
    params = jmod.init({"params": rng, "sample": rng}, jnp.asarray(x))[
        "params"]
  params = jax.device_get(params)
  pmod.build(in_shape, torch.Generator().manual_seed(0))
  pmod.load_state_dict(from_jax_params(params), strict=True)
  got, want = _flat(to_jax_params(pmod)), _flat(params)
  assert set(got) == set(want)
  for k, w in want.items():
    assert got[k].shape == w.shape, k
    np.testing.assert_array_equal(got[k], w, err_msg=k)
  pmod.eval()
  if in_shape is None:
    want = jmod.apply({"params": params}, method=jmod.distribution).mean()
    got = pmod().mean()
  elif name == "variational":
    want = jmod.apply({"params": params}, jnp.asarray(x),
                      mutable=["losses"])[0]
    got = pmod(torch.from_numpy(x))
  else:
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = pmod(torch.from_numpy(x))
    want = [d.mean() for d in (want if isinstance(want, tuple) else (want,))]
    got = [d.mean() for d in (got if isinstance(got, tuple) else (got,))]
  for g, w in zip(got if isinstance(got, list) else [got],
                  want if isinstance(want, list) else [want]):
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5,
                               atol=ATOL)
