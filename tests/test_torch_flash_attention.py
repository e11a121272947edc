"""The port's flash attention (odin_tpu_torch.ops.flash_attention) against
the JAX package's (odin_tpu.ops.pallas_attention), the Pallas kernel run in
interpret mode, on the same numpy inputs.

On the CPU the port's forward is its plain version, so these tests hold the
kernel's function and its users' entry points to JAX's kernel; the CUDA
kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py).  Tolerances are the JAX package's own
(tests/test_flash_attention.py): 2e-5 on fp32 outputs, 1e-4 on gradients.
bf16 and fp16 outputs: both sides round each output once to the 16-bit
type (the kernel after fp32 sums, the reference after JAX's own 16-bit
steps), so the limit is two roundings of that output, 2^-6·|want| in bf16
and 2^-9·|want| in fp16, beside 1e-5 for fp32 sums taken in another
order."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from odin_tpu.ops import pallas_attention as jpa
from odin_tpu_torch.ops.flash_attention import (
    dot_product_attention, flash_attention, flash_attention_fn,
    flash_attention_reference, reference_attention)

torch.set_num_threads(1)

ATOL = 2e-5
GRAD_ATOL = 1e-4
BF16_RTOL = 2 ** -6
BF16_ATOL = 1e-5
FP16_RTOL = 2 ** -9
# per dtype: (rtol, atol) against JAX
TOLS = {"float32": (0.0, ATOL), "bfloat16": (BF16_RTOL, BF16_ATOL),
        "float16": (FP16_RTOL, BF16_ATOL)}


def _rand(seed, *shape):
  return (np.random.RandomState(seed).randn(*shape) * 0.5).astype(np.float32)


def _qkv(seed, b, h, tq, tk, d):
  return (_rand(seed, b, h, tq, d), _rand(seed + 1, b, h, tk, d),
          _rand(seed + 2, b, h, tk, d))


def _jax_flash(q, k, v, **kw):
  with pltpu.force_tpu_interpret_mode():
    return np.asarray(jpa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


def _port_flash(q, k, v, **kw):
  with torch.no_grad():
    return flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), **kw).numpy()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax_kernel(causal):
  q, k, v = _qkv(0, 1, 2, 200, 200, 32)
  np.testing.assert_allclose(_port_flash(q, k, v, causal=causal),
                             _jax_flash(q, k, v, causal=causal), atol=ATOL)


def _assert_close(got, want, dtype):
  rtol, atol = TOLS[dtype]
  assert str(got.dtype).split(".")[-1] == dtype
  np.testing.assert_allclose(got.float().numpy(),
                             np.asarray(want, np.float32), rtol=rtol,
                             atol=atol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,d", [("float16", 64), ("bfloat16", 256),
                                     ("float32", 200), ("float32", 320)])
def test_flash_dtypes_and_head_dims_match_jax(dtype, d, causal):
  """Every dtype and head dim JAX's kernel takes (it pads D to a multiple
  of 128), with Tq != Tk; the output comes back in q's dtype."""
  q, k, v = _qkv(30, 1, 2, 40, 56, d)
  with pltpu.force_tpu_interpret_mode():
    want = jpa.flash_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                               causal=causal)
  assert want.dtype == jnp.dtype(dtype)
  with torch.no_grad():
    got = flash_attention(*(torch.from_numpy(x).to(getattr(torch, dtype))
                            for x in (q, k, v)), causal=causal)
  _assert_close(got, want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype,d", [("float32", 64), ("float32", 200),
                                     ("bfloat16", 256), ("float16", 64),
                                     ("float32", 320)])
def test_flash_attention_fn_dtypes_and_head_dims_match_jax(dtype, d):
  """The (B, T, H, D) entry point in every dtype, above 128 and 256."""
  rs = np.random.RandomState(d)
  q, k, v = ((rs.randn(2, t, 2, d) * 0.5).astype(np.float32)
             for t in (33, 47, 47))
  with pltpu.force_tpu_interpret_mode():
    want = jpa.flash_attention_fn(*(jnp.asarray(x, dtype)
                                    for x in (q, k, v)))
  with torch.no_grad():
    got = flash_attention_fn(*(torch.from_numpy(x).to(getattr(torch, dtype))
                               for x in (q, k, v)))
  assert tuple(got.shape) == (2, 33, 2, d)
  _assert_close(got, want.astype(jnp.float32), dtype)


def _flax_dropout_case(seed, broadcast):
  """(B, T, H, D) inputs, a dropout key, and the keep mask flax draws from
  it: ``bernoulli(rng, 1 - rate, shape)`` in flax's shape."""
  rs = np.random.RandomState(seed)
  q, k, v = ((rs.randn(2, t, 3, 8) * 0.5).astype(np.float32)
             for t in (10, 14, 14))
  rng = jax.random.PRNGKey(seed)
  shape = (1, 1, 10, 14) if broadcast else (2, 3, 10, 14)
  keep = np.array(jax.random.bernoulli(rng, 0.7, shape))
  return q, k, v, rng, keep


@pytest.mark.parametrize("broadcast", [True, False])
def test_flash_attention_fn_dropout_matches_flax(broadcast):
  """Dropout at rate 0.3 under the keep mask flax draws, handed to the
  port (the two packages' generators differ)."""
  q, k, v, rng, keep = _flax_dropout_case(33, broadcast)
  want = jpa.flash_attention_fn(
      *(jnp.asarray(x) for x in (q, k, v)), broadcast_dropout=broadcast,
      dropout_rng=rng, dropout_rate=0.3, deterministic=False)
  assert 0 < keep.sum() < keep.size
  got = flash_attention_fn(*(torch.from_numpy(x) for x in (q, k, v)),
                           broadcast_dropout=broadcast, dropout_rate=0.3,
                           dropout_mask=torch.from_numpy(keep))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
  # deterministic calls, and rate 0, drop nothing
  with pltpu.force_tpu_interpret_mode():
    want = jpa.flash_attention_fn(*(jnp.asarray(x) for x in (q, k, v)),
                                  dropout_rng=rng, dropout_rate=0.3,
                                  deterministic=True)
  got = flash_attention_fn(*(torch.from_numpy(x) for x in (q, k, v)),
                           dropout_rate=0.3, deterministic=True,
                           dropout_mask=torch.from_numpy(keep))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_dot_product_attention_draws_its_mask_from_the_generator():
  """Without a mask, the keep mask is drawn from ``dropout_rng`` in flax's
  broadcast shape: uniform < 1 - rate."""
  q, k, v, _, _ = _flax_dropout_case(36, True)
  tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
  got = dot_product_attention(tq, tk, tv, dropout_rate=0.3,
                              dropout_rng=torch.Generator().manual_seed(5))
  keep = torch.rand((1, 1, 10, 14),
                    generator=torch.Generator().manual_seed(5)) < 0.7
  want = dot_product_attention(tq, tk, tv, dropout_rate=0.3,
                               dropout_mask=keep)
  torch.testing.assert_close(got, want, rtol=0, atol=0)
  with pytest.raises(ValueError, match="dropout_rng"):
    dot_product_attention(tq, tk, tv, dropout_rate=0.3)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_cross_attention_lengths(causal):
  """Tq != Tk, neither a multiple of a tile; causal is top-left aligned."""
  q, k, v = _qkv(3, 1, 1, 130, 300, 16)
  np.testing.assert_allclose(_port_flash(q, k, v, causal=causal),
                             _jax_flash(q, k, v, causal=causal), atol=ATOL)


def test_flash_explicit_sm_scale():
  q, k, v = _qkv(6, 1, 2, 70, 90, 24)
  np.testing.assert_allclose(_port_flash(q, k, v, sm_scale=0.3),
                             _jax_flash(q, k, v, sm_scale=0.3), atol=ATOL)


def test_flash_bf16():
  """The kernel takes the scores and p·V in fp32 and casts the output."""
  q, k, v = _qkv(9, 1, 2, 130, 130, 32)
  with pltpu.force_tpu_interpret_mode():
    want = jpa.flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                                 for x in (q, k, v)))
  want = np.asarray(want.astype(jnp.float32))
  with torch.no_grad():
    got = flash_attention(*(torch.from_numpy(x).bfloat16()
                            for x in (q, k, v)))
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL,
                             atol=BF16_ATOL)


def test_flash_gradients_match_jax():
  """The backward recomputes JAX's reference attention, causal."""
  q, k, v = _qkv(12, 1, 1, 150, 150, 16)
  w = _rand(15, 1, 1, 150, 16)

  def loss(q_, k_, v_):
    return jnp.sum(jpa.flash_attention(q_, k_, v_, None, True) * w)

  with pltpu.force_tpu_interpret_mode():
    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
  tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
  (flash_attention(tq, tk, tv, causal=True) *
   torch.from_numpy(w)).sum().backward()
  for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_matches_jax(causal):
  """The backward's function, fp32 and bf16 (JAX's own roundings)."""
  q, k, v = _qkv(18, 2, 2, 40, 56, 8)
  want = jpa._reference_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), 0.35, causal)
  got = reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), 0.35, causal)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
  want = jpa._reference_attention(*(jnp.asarray(x, jnp.bfloat16)
                                    for x in (q, k, v)), 0.35, causal)
  got = reference_attention(*(torch.from_numpy(x).bfloat16()
                              for x in (q, k, v)), 0.35, causal)
  assert got.dtype == torch.bfloat16
  np.testing.assert_allclose(got.float().numpy(),
                             np.asarray(want.astype(jnp.float32)),
                             rtol=BF16_RTOL, atol=BF16_ATOL)


def test_reference_row_without_keys_gives_zero():
  q = torch.randn(1, 1, 3, 4)
  k = v = torch.zeros(1, 1, 0, 4)
  out = flash_attention_reference(q, k, v, 0.5, False)
  assert out.shape == (1, 1, 3, 4)
  assert not out.any()


@pytest.mark.parametrize("masked", [False, True])
def test_flash_attention_fn_matches_jax(masked):
  """(B, T, H, D) layout; a mask takes flax's plain attention."""
  rs = np.random.RandomState(21)
  q = (rs.randn(2, 70, 2, 16) * 0.5).astype(np.float32)
  k = (rs.randn(2, 90, 2, 16) * 0.5).astype(np.float32)
  v = (rs.randn(2, 90, 2, 16) * 0.5).astype(np.float32)
  mask = rs.rand(2, 1, 70, 90) < 0.7 if masked else None
  with pltpu.force_tpu_interpret_mode():
    want = np.asarray(jpa.flash_attention_fn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if mask is None else jnp.asarray(mask)))
  with torch.no_grad():
    got = flash_attention_fn(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=None if mask is None else torch.from_numpy(mask)).numpy()
  assert got.shape == (2, 70, 2, 16)
  np.testing.assert_allclose(got, want, atol=ATOL)


def test_flash_attention_fn_bias_matches_flax():
  from flax.linen.attention import dot_product_attention
  rs = np.random.RandomState(24)
  q, k, v = (rs.randn(1, 12, 2, 8).astype(np.float32) for _ in range(3))
  bias = rs.randn(1, 2, 12, 12).astype(np.float32)
  want = np.asarray(dot_product_attention(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jnp.asarray(bias)))
  got = flash_attention_fn(*(torch.from_numpy(x) for x in (q, k, v)),
                           bias=torch.from_numpy(bias))
  np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
  q, k, v = (torch.from_numpy(x) for x in _qkv(27, 1, 1, 20, 20, 8))
  before = flash_attention.launches
  got = flash_attention(q, k, v, causal=True)
  assert flash_attention.launches == before
  torch.testing.assert_close(
      got, flash_attention_reference(q, k, v, 8 ** -0.5, True),
      rtol=0, atol=0)


def test_flash_attention_rejects_what_the_kernel_does_not_take():
  """What JAX computes is taken (D 129, float16, dropout: held to JAX
  here); shapes that do not fit and other dtypes are refused."""
  q, k, v = _qkv(39, 1, 1, 9, 12, 129)
  np.testing.assert_allclose(_port_flash(q, k, v), _jax_flash(q, k, v),
                             atol=ATOL)
  with pltpu.force_tpu_interpret_mode():
    want = jpa.flash_attention(*(jnp.asarray(x[..., :8], jnp.float16)
                                 for x in (q, k, v)))
  with torch.no_grad():
    got = flash_attention(*(torch.from_numpy(x[..., :8].copy()).half()
                            for x in (q, k, v)))
  _assert_close(got, want.astype(jnp.float32), "float16")
  xq, xk, xv, rng, keep = _flax_dropout_case(42, True)
  want = jpa.flash_attention_fn(*(jnp.asarray(x) for x in (xq, xk, xv)),
                                dropout_rng=rng, dropout_rate=0.3)
  got = flash_attention_fn(*(torch.from_numpy(x) for x in (xq, xk, xv)),
                           dropout_rate=0.3,
                           dropout_mask=torch.from_numpy(keep))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
  with pytest.raises(ValueError):
    flash_attention(torch.zeros(1, 1, 4, 8), torch.zeros(1, 1, 5, 8),
                    torch.zeros(1, 1, 6, 8))
  with pytest.raises(TypeError):
    flash_attention(*(torch.zeros(1, 1, 4, 8, dtype=torch.float64),) * 3)
