"""The flax -> torch weight bridge (odin_tpu_torch.weights), one test per
layout rule: each holds one flax layer of odin_tpu.networks and its port
layer, on the same weights and inputs, to atol 1e-5 (fp32 sums taken in a
different order)."""
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
