"""The port's TDNN layers and x-vector network
(``odin_tpu_torch/networks/time_delay.py``) against the JAX package's
(``odin_tpu/networks/time_delay.py``), on the same numpy inputs and the
port's weights carried over by the bridge: each class (evenly spaced and
irregular contexts, odd and even kernels with dilation, the tied kernel,
statistics pooling), ``XVectorNet`` at full width over a short utterance,
and the x-vector recipe's loss with one AdamW step against
``optax.adamw``.

Tolerances (``tests/torch_layer_common.py``): outputs within 1e-5 of
their largest magnitude, gradients within 1e-4 of each tensor's largest.
Params after one AdamW step: every element within 2·lr of JAX's, all but
a 2e-5 share within 1e-5 (Adam's first update is about lr·sign(g), so
an element whose gradient is rounding-sized may take either sign, as
``tests/test_torch_optimizer.py`` holds it).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import odin_tpu.networks.time_delay as J
import odin_tpu_torch.networks.time_delay as P
from odin_tpu_torch.training.core import AdamW
from odin_tpu_torch.weights import from_jax_params, to_jax_params
from torch_layer_common import GRAD_TOL, OUT_TOL, check_layer, close, \
    shape_build

B, T, F = 2, 17, 6

LAYERS = {
    "context_default": (lambda m: m.TimeDelay(5),),
    "context_dilated": (lambda m: m.TimeDelay(4, context=(-4, 0, 4),
                                              activation="tanh"),),
    "context_irregular": (lambda m: m.TimeDelay(5, context=(1, -3, 0)),),
    "context_irregular_nobias": (lambda m: m.TimeDelay(
        3, context=(-2, 0, 3), use_bias=False, activation="elu"),),
    "context_single": (lambda m: m.TimeDelay(4, context=(2,)),),
    "dense": (lambda m: m.TimeDelayDense(7),),
    "conv": (lambda m: m.TimeDelayConv(5),),
    "conv_dilated": (lambda m: m.TimeDelayConv(4, kernel_size=3,
                                               dilation=2),),
    "conv_even": (lambda m: m.TimeDelayConv(4, kernel_size=4),),
    "conv_even_dilated": (lambda m: m.TimeDelayConv(3, kernel_size=2,
                                                    dilation=3),),
    "conv_one": (lambda m: m.TimeDelayConv(4, kernel_size=1,
                                           activation="linear"),),
    "tied": (lambda m: m.TimeDelayConvTied(5),),
    "tied_even": (lambda m: m.TimeDelayConvTied(4, kernel_size=2,
                                                dilations=(1, 2)),),
    "statspool": (lambda m: m.StatsPool(),),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
  make, = LAYERS[name]
  x = np.random.RandomState(1).randn(B, T, F).astype(np.float32)
  check_layer(make(P), make(J), [x], shape_build((T, F)))


def test_irregular_context_columns_in_offset_order():
  """The Dense of an irregular context reads the frames at the sorted
  offsets, concatenated in that order."""
  m = P.TimeDelay(2, context=(3, -1, 0), activation="linear", use_bias=False)
  m.build((None, 1), torch.Generator().manual_seed(0))
  with torch.no_grad():
    m.weight.copy_(torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]))
  x = torch.arange(8.0).reshape(1, 8, 1)
  y = m(x)
  assert y.shape == (1, 4, 2)  # span 5: 8 - 5 + 1 frames
  assert torch.equal(y[0, :, 0], torch.arange(4.0))  # offset 0 (context -1)
  assert torch.equal(y[0, :, 1], torch.arange(4.0) + 4)  # context 3
  assert m.flax_kind is P.Dense and not m.regular


def test_statspool_floor():
  """A constant input has variance 0: the deviation is sqrt(1e-8)."""
  x = torch.ones(2, 5, 3)
  y = P.StatsPool()(x)
  assert torch.equal(y[:, :3], torch.ones(2, 3))
  torch.testing.assert_close(y[:, 3:], torch.full((2, 3), 1e-4))


def _xvector(n_classes, frames, feats=20, batch=2, seed=0):
  port = P.XVectorNet(n_classes=n_classes)
  port.build((None, feats), torch.Generator().manual_seed(seed))
  x = np.random.RandomState(seed + 1).randn(batch, frames, feats).astype(
      np.float32)
  return port, J.XVectorNet(n_classes=n_classes), x


def test_xvector_full_width_matches_jax():
  """XVectorNet(n_classes=8) at its published widths on 20-dim features:
  the JAX model's 4,461,028 parameters, the logits, the embedding
  (``return_embedding``, before the ReLU) and the gradients."""
  port, jnet, x = _xvector(8, 30)
  assert sum(p.numel() for p in port.parameters()) == 4_461_028
  y = check_layer(port, jnet, [x], lambda p, g: None)
  assert y.shape == (2, 8)
  params = to_jax_params(port)
  emb = jnet.apply({"params": params}, jnp.asarray(x), return_embedding=True)
  with torch.no_grad():
    got = port(torch.from_numpy(x), return_embedding=True)
  assert got.shape == (2, 512)
  close(got.numpy(), emb, OUT_TOL, "embedding_a")
  # n_classes 0: the embedding, and no embedding_b or classifier
  bare = P.XVectorNet()
  bare.build((None, 20))
  assert not hasattr(bare, "classifier")
  assert bare(torch.from_numpy(x)).shape == (2, 512)


def test_recipe_loss_and_one_adamw_step_match_optax():
  """``examples/voxceleb/recipe.py``'s loss (the mean cross-entropy of
  whole utterances) and one ``optax.adamw(1e-3, weight_decay=1e-4)``
  step, against the port's ``AdamW`` on the same params and batch."""
  lr, wd = 1e-3, 1e-4
  port, jnet, x = _xvector(6, 24, batch=4, seed=3)
  labels = np.array([0, 5, 2, 2])
  params = to_jax_params(port)

  def jloss(p):
    logits = jnet.apply({"params": p}, jnp.asarray(x), training=True)
    return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(4), labels])

  opt = optax.adamw(lr, weight_decay=wd)
  jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
  upd, _ = opt.update(jg, opt.init(params), params)
  jnew = optax.apply_updates(params, upd)

  tparams = dict(port.named_parameters())
  logits = port(torch.from_numpy(x))
  loss = -torch.mean(torch.log_softmax(logits, -1)[torch.arange(4),
                                                   torch.from_numpy(labels)])
  grads = dict(zip(tparams, torch.autograd.grad(loss, list(
      tparams.values()))))
  close(float(loss.detach()), float(jl), OUT_TOL, "loss")
  want_g = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
  for k, g in jax.tree_util.tree_flatten_with_path(
      to_jax_params(port, grads))[0]:
    close(g, want_g[k], GRAD_TOL, jax.tree_util.keystr(k))
  popt = AdamW(lr, weight_decay=wd)
  with torch.no_grad():
    p0 = {"net": {k: v.detach() for k, v in tparams.items()}}
    u, _ = popt.update({"net": grads}, popt.init(p0), p0)
    new = {k: p0["net"][k] + u["net"][k] for k in p0["net"]}
  got = from_jax_params(jax.device_get(jnew))
  apart = np.concatenate([np.abs(new[k].numpy() - got[k].numpy()).ravel()
                          for k in new])
  assert apart.max() <= 2 * lr
  assert np.mean(apart > 1e-5) <= 2e-5
