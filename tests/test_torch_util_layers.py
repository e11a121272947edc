"""The port's utility layers (``odin_tpu_torch/networks/util_layers.py``)
against the JAX package's (``odin_tpu/networks/util_layers.py``), on the
same numpy inputs and the port's weights carried over by the bridge: the
15 layers, the recurrent ones in both ``return_sequences`` modes,
``BatchRenormalization`` in eval mode and over three training calls, and
``Resampling2D``'s methods at factors above and below 1.

Tolerances (``tests/torch_layer_common.py``): outputs within 1e-5 of
their largest magnitude, gradients within 1e-4 of each tensor's largest,
the running statistics within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odin_tpu.networks.base as JB
import odin_tpu.networks.util_layers as J
import odin_tpu_torch.networks.base as PB
import odin_tpu_torch.networks.util_layers as P
from odin_tpu_torch.networks.base import collecting_updates
from odin_tpu_torch.weights import from_jax_mutables, to_jax_mutables, \
    to_jax_params
from torch_layer_common import OUT_TOL, check_layer, close, shape_build

B = 3


def _x(*shape, seed=1, scale=1.0, shift=0.0):
  return (np.random.RandomState(seed).randn(*shape) * scale + shift).astype(
      np.float32)


# name: (make(module of layers, module of base), input shapes without B)
LAYERS = {
    "identity": (lambda m, b: m.Identity(), [(4, 5)]),
    "expand_last": (lambda m, b: m.ExpandDims(), [(4, 5)]),
    "expand_1": (lambda m, b: m.ExpandDims(1), [(4, 5)]),
    "reduce_mean": (lambda m, b: m.Reduce(), [(4, 5)]),
    "reduce_sum_last": (lambda m, b: m.Reduce("sum", -1), [(4, 5)]),
    "reduce_max": (lambda m, b: m.Reduce("max", 2), [(4, 5)]),
    "reduce_min": (lambda m, b: m.Reduce("min", 1), [(4, 5)]),
    "reduce_prod": (lambda m, b: m.Reduce("prod", 1), [(3, 5)]),
    "reduce_std": (lambda m, b: m.Reduce("std", 1), [(4, 5)]),
    "reduce_var": (lambda m, b: m.Reduce("var", -1), [(4, 5)]),
    "reduce_median": (lambda m, b: m.Reduce("median", 1), [(5, 4)]),
    "conv1d_transpose": (lambda m, b: m.Conv1DTranspose(4), [(7, 3)]),
    "conv1d_transpose_s2": (lambda m, b: m.Conv1DTranspose(
        4, 3, 2, "elu"), [(7, 3)]),
    "conv1d_transpose_k4s2": (lambda m, b: m.Conv1DTranspose(
        5, 4, 2), [(6, 2)]),
    "conv1d_transpose_valid": (lambda m, b: m.Conv1DTranspose(
        3, 2, 3, "tanh", "VALID"), [(5, 4)]),
    "conv1d_transpose_k1s3": (lambda m, b: m.Conv1DTranspose(
        3, 1, 3, None, "VALID"), [(5, 4)]),
    "renorm": (lambda m, b: m.BatchRenormalization(), [(4, 5)]),
    "parallel": (lambda m, b: m.ParallelNetwork(
        (b.Dense(3, "relu"), b.Dense(2))), [(4, 5)]),
    "parallel_axis1": (lambda m, b: m.ParallelNetwork(
        (b.Dense(3), b.Dense(3, "tanh")), axis=1), [(4, 5)]),
    "positional": (lambda m, b: m.PositionalEncoder(), [(7, 6)]),
    "positional_short": (lambda m, b: m.PositionalEncoder(50), [(9, 5)]),
    "skip_proj": (lambda m, b: m.SkipConnection(b.Dense(6, "relu")),
                  [(4, 5)]),
    "skip_add": (lambda m, b: m.SkipConnection(b.Dense(5, "tanh")),
                 [(4, 5)]),
    "skip_concat": (lambda m, b: m.SkipConnection(b.Dense(3), "concat"),
                    [(4, 5)]),
    "depth_to_space": (lambda m, b: m.DepthToSpace(), [(3, 2, 8)]),
    "depth_to_space_3": (lambda m, b: m.DepthToSpace(3), [(2, 2, 18)]),
}
for _cls in ("LSTM", "GRU", "SimpleRNN"):
  for _seq in (True, False):
    LAYERS[f"{_cls.lower()}_{'seq' if _seq else 'last'}"] = (
        lambda m, b, c=_cls, s=_seq: getattr(m, c)(5, return_sequences=s),
        [(6, 4)])
for _method in ("nearest", "linear", "cubic", "lanczos3"):
  for _factor in (2.0, 0.5, 1.5, 0.7):
    LAYERS[f"resample_{_method}_{_factor}"] = (
        lambda m, b, f=_factor, me=_method: m.Resampling2D(f, me),
        [(7, 6, 2)])


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
  make, shapes = LAYERS[name]
  xs = [_x(B, *s, seed=i + 1) for i, s in enumerate(shapes)]
  if name == "reduce_prod":
    xs = [np.abs(x) + 0.5 for x in xs]
  check_layer(make(P, PB), make(J, JB), xs, shape_build(*shapes))


def test_renorm_trains_like_jax_over_three_calls():
  """Three training calls on shifted, scaled batches (so that r and d
  clip at rmax and dmax on the first): each call's output and gradients,
  and the running mean and biased variance moved after each."""
  port, jmod = P.BatchRenormalization(), J.BatchRenormalization()
  port.build((5,), torch.Generator().manual_seed(0))
  for call in range(3):
    x = _x(16, 5, seed=10 + call, scale=8.0, shift=4.0 * (call + 1))
    check_layer(port, jmod, [x], lambda p, g: None, training=True)
    # move the port's buffers as a step's state would
    with collecting_updates() as updates:
      port(torch.from_numpy(x))
    for (mod, name), v in updates.items():
      getattr(mod, name).copy_(v.detach())
  assert float(port.mean.abs().min()) > 0.0


def test_renorm_training_then_eval_matches_jax():
  """Eval mode after a training call reads the moved statistics."""
  jmod = J.BatchRenormalization()
  x = _x(8, 5, scale=3.0, shift=1.0)
  v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
  _, upd = jmod.apply(v, jnp.asarray(x), training=True,
                      mutable=["batch_stats"])
  port = P.BatchRenormalization()
  port.build((5,))
  for k, t in from_jax_mutables(jax.device_get(upd)).items():
    getattr(port, k).copy_(t)
  port.eval()
  want = jmod.apply({"params": v["params"], **upd}, jnp.asarray(x))
  close(port(torch.from_numpy(x)).detach().numpy(), want, OUT_TOL)
  assert set(to_jax_mutables(port)["batch_stats"]) == {"mean", "var"}


@pytest.mark.parametrize("soft", [False, True])
def test_conditional_embedding_matches_jax(soft):
  """Integer labels look up the table; one-hot or soft labels multiply
  it."""
  n, feats = 6, 4
  rs = np.random.RandomState(3)
  if soft:
    y = rs.dirichlet(np.ones(n), size=B).astype(np.float32)
    shape = (n,)
  else:
    y = rs.randint(0, n, size=B).astype(np.int32)
    shape = ()
  out = check_layer(P.ConditionalEmbedding(n, feats),
                    J.ConditionalEmbedding(n, feats), [y],
                    shape_build(shape))
  assert out.shape == (B, feats)


@pytest.mark.parametrize("method,feats", [("add", 4), ("add", 6),
                                          ("concat", 4), ("film", 4)])
def test_conditional_projection_matches_jax(method, feats):
  """Labels (B, 3) merged into x (B, 5, 6): added (x projected where its
  width differs), concatenated, or as FiLM."""
  x, y = _x(B, 5, 6), _x(B, 3, seed=2)
  check_layer(P.ConditionalProjection(feats, method),
              J.ConditionalProjection(feats, method), [x, y],
              shape_build((5, 6), (3,)))


def test_depth_to_space_order_is_jax_not_pixel_shuffle():
  """Channels are read as (r, r, C) in NHWC order: for C·r² = 8 at r 2
  the output's first pixel row holds channels 0-1 and 2-3, which
  ``pixel_shuffle``'s (C, r, r) order would not give."""
  x = torch.arange(8.0).reshape(1, 1, 1, 8)
  y = P.DepthToSpace(2)(x)
  assert y.shape == (1, 2, 2, 2)
  assert y[0, 0, 0].tolist() == [0.0, 1.0]
  assert y[0, 0, 1].tolist() == [2.0, 3.0]
  assert y[0, 1, 0].tolist() == [4.0, 5.0]
  ps = torch.nn.functional.pixel_shuffle(x.permute(0, 3, 1, 2), 2)
  assert not torch.equal(ps.permute(0, 2, 3, 1), y)


def test_resampling_weights_are_jax_scale_and_translate():
  """The per-axis matrices equal JAX's ``compute_weight_mat`` (Keys' cubic
  at a = -0.5, antialiased when shrinking), and 'nearest' samples at
  half-pixel centres (torch's 'nearest-exact', not 'nearest')."""
  from jax._src.image import scale as jscale
  for n, m in ((7, 14), (7, 3), (6, 9), (9, 4)):
    for method, kernel in (("linear", jscale._fill_triangle_kernel),
                           ("cubic", jscale._fill_keys_cubic_kernel)):
      want = jscale.compute_weight_mat(n, m, m / n, 0.0, kernel, True)
      close(P.resize_weights(n, m, method).numpy(), want, 1e-6,
            f"{method} {n}->{m}")
  x = torch.arange(10.0).reshape(1, 2, 5, 1)
  got = P.Resampling2D(1.6, "nearest")(x)
  exact = torch.nn.functional.interpolate(
      x.permute(0, 3, 1, 2), size=(3, 8), mode="nearest-exact")
  assert torch.equal(got, exact.permute(0, 2, 3, 1))


def test_recurrent_layers_start_from_zero_carry():
  """One step from a zero carry: the LSTM's h is o·tanh(i·g) (f meets a
  zero cell), the simple cell's tanh(W x + b)."""
  x = torch.from_numpy(_x(2, 1, 3))
  lstm = P.LSTM(4)
  lstm.build((1, 3), torch.Generator().manual_seed(0))
  z = torch.nn.functional.linear(x[:, 0], lstm.cell.weight_ih) + \
      lstm.cell.bias_hh
  i, _, g, o = z.chunk(4, -1)
  want = torch.sigmoid(o) * torch.tanh(torch.sigmoid(i) * torch.tanh(g))
  torch.testing.assert_close(lstm(x)[:, 0], want)
  rnn = P.SimpleRNN(4, return_sequences=False)
  rnn.build((1, 3), torch.Generator().manual_seed(0))
  torch.testing.assert_close(rnn(x), torch.tanh(torch.nn.functional.linear(
      x[:, 0], rnn.cell.weight_ih, rnn.cell.bias_ih)))
  assert set(to_jax_params(rnn)["cell"]) == {"i", "h"}
