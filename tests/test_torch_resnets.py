"""The port's residual blocks, squeeze-excitation, masked convolutions and
PixelCNN decoder (``odin_tpu_torch/networks/resnets.py``) against the JAX
package's modules: the port builds its parameters, the weight bridge
carries them to a flax tree, which must have the paths and shapes of the
JAX module's own init (``jax.eval_shape``); then both apply to the same
numpy input, and the outputs, the input's gradient and every parameter's
gradient agree (rtol 1e-5; gradients within 1e-4 of each tensor's
largest value).  BatchNorm runs in both modes: eval on bridged running
averages, training with the moved averages compared too.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odin_tpu.networks.resnets as J
import odin_tpu_torch.networks.resnets as P
from odin_tpu_torch.networks.base import collecting_updates
from odin_tpu_torch.weights import (from_jax_mutables, from_jax_params,
                                    to_jax_mutables, to_jax_params)

RTOL, GRAD_TOL = 1e-5, 1e-4


def _leaves(tree):
  return {jax.tree_util.keystr(k): tuple(np.shape(v)) for k, v in
          jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check(port, jmod, in_shape, seed=0, training=False, batch=2):
  """Build `port` on `in_shape`, hold its bridged tree against `jmod`'s
  init, then its outputs and gradients against ``jmod.apply``."""
  port.build(in_shape, torch.Generator().manual_seed(seed))
  x = np.random.RandomState(seed).randn(batch, *in_shape).astype(np.float32)
  init = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)))
  params = to_jax_params(port)
  assert _leaves(params) == _leaves(init.get("params", {}))
  mutables = to_jax_mutables(port)
  assert _leaves(mutables) == _leaves(
      {k: v for k, v in init.items() if k != "params"})
  # the bridge both ways: the port's state dict from the flax tree
  sd = port.state_dict()
  back = from_jax_params(params)
  back.update(from_jax_mutables(mutables))
  assert set(back) == {k for k in sd if not k.endswith("mask")}
  for k, v in back.items():
    assert torch.equal(v, sd[k]), k

  r = np.random.RandomState(seed + 1)
  port.train(training)

  def jloss(p, xx):
    out = jmod.apply({"params": p, **mutables}, xx, training=training,
                     mutable=list(mutables) if training else False)
    y, upd = out if training else (out, {})
    return jnp.sum(y * w), (y, upd)

  with torch.no_grad(), collecting_updates():
    out_shape = tuple(port(torch.from_numpy(x)).shape)
  tw = torch.from_numpy(r.randn(*out_shape).astype(np.float32))
  w = jnp.asarray(tw.numpy())
  (_, (jy, jupd)), (jgp, jgx) = jax.jit(jax.value_and_grad(
      jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
  tx = torch.from_numpy(x).requires_grad_(True)
  with collecting_updates() as updates:
    y = port(tx)
  torch.sum(y * tw).backward()
  np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=RTOL,
                             atol=RTOL * float(np.abs(jy).max()))
  gx = np.asarray(jgx)
  np.testing.assert_allclose(tx.grad.numpy(), gx, rtol=GRAD_TOL,
                             atol=GRAD_TOL * float(np.abs(gx).max()))
  grads = to_jax_params(port, {n: p.grad for n, p in
                               port.named_parameters()})
  want = dict(jax.tree_util.tree_flatten_with_path(jgp)[0])
  top = max([float(np.abs(v).max()) for v in want.values()] + [0.0])
  for k, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
    wg = np.asarray(want[k])
    # a bias feeding a BatchNorm in training has a vanishing gradient:
    # both packages' are rounding, held within 1e-6 of the block's largest
    scale = max(float(np.abs(wg).max()), 1e-2 * top)
    np.testing.assert_allclose(g, wg, rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                               err_msg=jax.tree_util.keystr(k))
  if training and mutables:
    names = {f"{m_name}.{b}" if m_name else b: v
             for (mod, b), v in updates.items()
             for m_name, m in port.named_modules() if m is mod}
    for name, v in from_jax_mutables(jupd).items():
      np.testing.assert_allclose(names[name].detach().numpy(), v.numpy(),
                                 rtol=RTOL, atol=1e-6, err_msg=name)
  return y


BLOCKS = {
    "gating": (lambda: P.SigmoidGating(), lambda: J.SigmoidGating(),
               (4, 4, 6)),
    "se": (lambda: P.SqueezeExcitation(), lambda: J.SqueezeExcitation(),
           (5, 5, 8)),
    "se_ratio_8": (lambda: P.SqueezeExcitation(8),
                   lambda: J.SqueezeExcitation(8), (4, 4, 4)),
    "block": (lambda: P.ResidualBlock(6), lambda: J.ResidualBlock(6),
              (6, 6, 6)),
    "block_projected": (lambda: P.ResidualBlock(8, 3, 2, "elu", True),
                        lambda: J.ResidualBlock(8, 3, 2, "elu", True),
                        (8, 8, 4)),
    "block_bn": (lambda: P.ResidualBlock(4, batchnorm=True),
                 lambda: J.ResidualBlock(4, batchnorm=True), (6, 6, 3)),
    "up_block": (lambda: P.ResidualUpBlock(6, 3, 2, "elu", True),
                 lambda: J.ResidualUpBlock(6, 3, 2, "elu", True),
                 (4, 4, 4)),
    "up_block_same": (lambda: P.ResidualUpBlock(4, 3, 1),
                      lambda: J.ResidualUpBlock(4, 3, 1), (5, 5, 4)),
    "bottleneck": (lambda: P.ResidualBottleneck(),
                   lambda: J.ResidualBottleneck(), (6, 6, 8)),
    "bottleneck_out": (lambda: P.residual_design(
        "bottleneck", 0.25, filters_out=6, strides=2, batchnorm=False),
                       lambda: J.residual_design(
        "bottleneck", 0.25, filters_out=6, strides=2, batchnorm=False),
                       (8, 8, 8)),
    "inverted_gated": (lambda: P.residual_design(
        "inverted", 2.0, sigmoid_gating=True, se_ratio=0.5),
                       lambda: J.residual_design(
        "inverted", 2.0, sigmoid_gating=True, se_ratio=0.5), (5, 5, 4)),
    "sequential_down": (lambda: P.ResidualSequential(
        (8, 8, 12), strides=(1, 2, 1), activation="elu", use_se=True),
                        lambda: J.ResidualSequential(
        (8, 8, 12), strides=(1, 2, 1), activation="elu", use_se=True),
                        (8, 8, 3)),
    "sequential_up": (lambda: P.ResidualSequential(
        (8, 8, 4, 4), strides=(-2, 1, -2, 1), activation="elu",
        use_se=True), lambda: J.ResidualSequential(
        (8, 8, 4, 4), strides=(-2, 1, -2, 1), activation="elu",
        use_se=True), (2, 2, 2)),
    "masked_a": (lambda: P.MaskedConv2D(5, 5, "A"),
                 lambda: J.MaskedConv2D(5, 5, "A"), (6, 6, 3)),
    "masked_b": (lambda: P.MaskedConv2D(5, 3, "B"),
                 lambda: J.MaskedConv2D(5, 3, "B"), (6, 6, 3)),
    "downsample": (lambda: P.DownSample(5), lambda: J.DownSample(5),
                   (8, 8, 3)),
    "upsample": (lambda: P.UpSample(5, 2, "elu"),
                 lambda: J.UpSample(5, 2, "elu"), (4, 4, 3)),
    "pixelcnn": (lambda: P.PixelCNNDecoder((8, 8, 3), 8, 2, 4),
                 lambda: J.PixelCNNDecoder((8, 8, 3), 8, 2, 4), (6,)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
  port, jmod, shape = BLOCKS[name]
  _check(port(), jmod(), shape)


@pytest.mark.parametrize("name", ["block_bn", "bottleneck"])
def test_batchnorm_blocks_train_like_jax(name):
  """In training mode: the batch's statistics, and the running averages
  the step hands back, as flax's mutable ``batch_stats``."""
  port, jmod, shape = BLOCKS[name]
  _check(port(), jmod(), shape, training=True, batch=4)


@pytest.mark.parametrize("mask_type", ["A", "B"])
def test_masked_conv_is_causal(mask_type):
  """Each output pixel depends only on the input pixels before it in
  raster order, and on itself only with mask 'B'."""
  m = P.MaskedConv2D(2, 5, mask_type)
  m.build((6, 6, 2), torch.Generator().manual_seed(0))
  with torch.no_grad():
    m.weight.copy_(torch.rand_like(m.weight) + 0.1)  # no tap is zero
  for i, j in [(0, 0), (2, 3), (5, 5), (3, 0)]:
    x = torch.randn(1, 6, 6, 2, requires_grad=True)
    m(x)[0, i, j].sum().backward()
    dep = x.grad[0].abs().sum(-1) > 0
    order = np.arange(36).reshape(6, 6)
    here = order[i, j]
    assert not dep[torch.from_numpy(order > here)].any()
    assert bool(dep[i, j]) == (mask_type == "B")
    if here > 0:
      assert dep[torch.from_numpy(order < here) &
                 torch.from_numpy(np.abs(np.arange(6)[:, None] - i) <= 2) &
                 torch.from_numpy(np.abs(np.arange(6)[None] - j) <= 2)].all()


def test_pixelcnn_decoder_shapes_and_names():
  """decoder0, MaskedConv2D_0 (7x7, A), n_layers 3x3 type-B convs, the
  1x1 Conv_0 to C·n_params maps."""
  d = P.PixelCNNDecoder((32, 32, 3), 32, 4, 30)
  assert d.build((16,)) == (32, 32, 90)
  assert [n for n, _ in d.named_children()] == [
      "MaskedConv2D_0", "MaskedConv2D_1", "MaskedConv2D_2", "MaskedConv2D_3",
      "MaskedConv2D_4", "Conv_0", "decoder0"] or sorted(
          n for n, _ in d.named_children()) == sorted(
              ["decoder0", "Conv_0"] + [f"MaskedConv2D_{i}"
                                        for i in range(5)])
  assert d.MaskedConv2D_0.kernel_size == (7, 7)
  assert d.MaskedConv2D_0.mask_type == "A"
  assert all(getattr(d, f"MaskedConv2D_{i}").mask_type == "B"
             for i in range(1, 5))
  y = d(torch.randn(2, 16))
  assert y.shape == (2, 32, 32, 90) and torch.isfinite(y).all()


def test_residual_design_rejects_unknown():
  with pytest.raises(NotImplementedError):
    P.residual_design("wide")
