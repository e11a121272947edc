"""The port's attention layers (odin_tpu_torch.networks.attention) against
the JAX package's (odin_tpu.networks.attention) on the same numpy inputs,
with the flax params carried across by odin_tpu_torch.weights.

``MultiHeadAttention(flash=True)`` runs JAX's Pallas kernel in interpret
mode and the port's kernel's plain version.  Tolerances: 2e-5 on outputs
and 1e-4 on gradients, the JAX package's own for attention
(tests/test_flash_attention.py).  The sampling alignments draw from
different generators in the two packages, so they are tested by their
properties."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from odin_tpu.networks import attention as ja
from odin_tpu_torch.networks import attention as ta
from odin_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

ATOL = 2e-5
GRAD_ATOL = 1e-4


def _x(seed, *shape):
  return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _carry(jax_module, port_module, *inputs, seed=0, **kw):
  """Init the flax module on `inputs`, build the port's on their shapes and
  load the same params; returns (params, port module)."""
  with pltpu.force_tpu_interpret_mode():
    variables = jax_module.init(jax.random.PRNGKey(seed),
                                *(jnp.asarray(x) for x in inputs), **kw)
  params = variables.get("params", {})  # a parameter-free layer has none
  params = jax.device_get(params)
  shapes = [x.shape[1:] for x in inputs]
  extra = dict(zip(("k_shape", "v_shape"), shapes[1:]))
  if isinstance(port_module, ta.MultiHeadAttention):
    extra["device"] = "cpu"
  port_module.build(shapes[0], **extra)
  port_module.load_state_dict(from_jax_params(params), strict=True)
  return params, port_module


def _mha_pair(flash, inputs, mask=None):
  jm = ja.MultiHeadAttention(num_heads=4, flash=flash)
  params, tm = _carry(jm, ta.MultiHeadAttention(num_heads=4, flash=flash),
                      *inputs)
  jmask = None if mask is None else jnp.asarray(mask)
  with pltpu.force_tpu_interpret_mode():
    want = np.asarray(jm.apply({"params": params},
                               *(jnp.asarray(x) for x in inputs), mask=jmask))
  return jm, params, tm, want


@pytest.mark.parametrize("flash", [False, True])
def test_mha_self_attention_matches_jax(flash):
  x = _x(0, 2, 16, 32)
  _, _, tm, want = _mha_pair(flash, (x,))
  with torch.no_grad():
    got = tm(torch.from_numpy(x)).numpy()
  assert got.shape == (2, 16, 32)
  np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("flash", [False, True])
def test_mha_cross_attention_matches_jax(flash):
  """k and v of another length and width than q."""
  q, kv = _x(1, 2, 10, 32), _x(2, 2, 24, 20)
  _, _, tm, want = _mha_pair(flash, (q, kv, kv))
  with torch.no_grad():
    got = tm(torch.from_numpy(q), torch.from_numpy(kv),
             torch.from_numpy(kv)).numpy()
  np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("flash", [False, True])
def test_mha_mask_matches_jax(flash):
  x = _x(3, 2, 16, 32)
  mask = np.random.RandomState(4).rand(2, 1, 16, 16) < 0.6
  mask[..., 0] = True
  _, _, tm, want = _mha_pair(flash, (x,), mask=mask)
  with torch.no_grad():
    got = tm(torch.from_numpy(x), mask=torch.from_numpy(mask)).numpy()
  np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("flash", [False, True])
def test_mha_input_gradient_matches_jax(flash):
  x = _x(5, 2, 16, 32)
  w = _x(6, 2, 16, 32)
  jm, params, tm, _ = _mha_pair(flash, (x,))

  def loss(x_):
    return jnp.sum(jm.apply({"params": params}, x_) * w)

  with pltpu.force_tpu_interpret_mode():
    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
  tx = torch.from_numpy(x).requires_grad_()
  (tm(tx) * torch.from_numpy(w)).sum().backward()
  np.testing.assert_allclose(tx.grad.numpy(), want, atol=GRAD_ATOL)


def test_mha_flash_and_plain_agree_on_weight_gradients():
  x = torch.from_numpy(_x(7, 2, 16, 32))
  w = torch.from_numpy(_x(8, 2, 16, 32))
  g = torch.Generator().manual_seed(0)
  plain = ta.MultiHeadAttention(num_heads=4)
  plain.build((16, 32), g, device="cpu")
  flash = ta.MultiHeadAttention(num_heads=4, flash=True)
  flash.build((16, 32), device="cpu")
  flash.load_state_dict(plain.state_dict())
  for m in (plain, flash):
    (m(x) * w).sum().backward()
  for (name, a), b in zip(plain.named_parameters(), flash.parameters()):
    np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(),
                               atol=GRAD_ATOL, err_msg=name)


SCORES = ["dot", "general", "cosine", "additive", "location"]
POSITIONS = ["global", "local_m", "local_p"]


@pytest.mark.parametrize("position", POSITIONS)
@pytest.mark.parametrize("score", SCORES)
def test_attention_modes_match_jax(score, position):
  q, k = _x(10, 2, 7, 12), _x(11, 2, 9, 12)
  jm = ja.Attention(units=8, score=score, position=position, window=4)
  params, tm = _carry(jm, ta.Attention(units=8, score=score,
                                       position=position, window=4), q, k)
  want_ctx, want_w = jm.apply({"params": params}, jnp.asarray(q),
                              jnp.asarray(k))
  with torch.no_grad():
    ctx, w = tm(torch.from_numpy(q), torch.from_numpy(k))
  np.testing.assert_allclose(w.numpy(), np.asarray(want_w), atol=ATOL)
  np.testing.assert_allclose(ctx.numpy(), np.asarray(want_ctx), atol=ATOL)


@pytest.mark.parametrize("tq,tk", [(5, 9), (9, 5), (6, 6)])
def test_attention_causal_is_bottom_right(tq, tk):
  """Attention's own causal mask, np.tril(k=Tk - Tq), with a mask too."""
  q, k = _x(12, 2, tq, 8), _x(13, 2, tk, 8)
  mask = np.random.RandomState(14).rand(2, tq, tk) < 0.8
  jm = ja.Attention(causal=True)
  params, tm = _carry(jm, ta.Attention(causal=True), q, k)
  want_ctx, want_w = jm.apply({"params": params}, jnp.asarray(q),
                              jnp.asarray(k), mask=jnp.asarray(mask))
  with torch.no_grad():
    ctx, w = tm(torch.from_numpy(q), torch.from_numpy(k),
                mask=torch.from_numpy(mask))
  np.testing.assert_allclose(w.numpy(), np.asarray(want_w), atol=ATOL)
  np.testing.assert_allclose(ctx.numpy(), np.asarray(want_ctx), atol=ATOL)
  # a row with a valid key puts no weight above the diagonal (a row with
  # none, the first Tq - Tk rows, spreads it evenly, as in JAX)
  allowed = np.tril(np.ones((tq, tk), bool), k=tk - tq) & mask
  rows = allowed.any(-1)
  assert rows.any()
  assert np.all(w.numpy()[~allowed & rows[..., None]] < 1e-6)


@pytest.mark.parametrize("wrapper", ["self", "global", "local_p"])
def test_attention_wrappers_match_jax(wrapper):
  q, k = _x(15, 2, 6, 10), _x(16, 2, 8, 10)
  if wrapper == "self":
    jm, tm, inputs = (ja.SelfAttention(units=6, causal=True),
                      ta.SelfAttention(units=6, causal=True), (q,))
  elif wrapper == "global":
    jm, tm, inputs = (ja.GlobalAttention(units=6, score="general"),
                      ta.GlobalAttention(units=6, score="general"), (q, k))
  else:
    jm, tm, inputs = (ja.LocalPredictiveAttention(units=6, window=3),
                      ta.LocalPredictiveAttention(units=6, window=3), (q, k))
  params, tm = _carry(jm, tm, *inputs)
  want = jm.apply({"params": params}, *(jnp.asarray(x) for x in inputs))
  with torch.no_grad():
    got = tm(*(torch.from_numpy(x) for x in inputs))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _sampling(align, estimator="st", seed=0):
  m = ta.Attention(align=align, estimator=estimator, temperature=0.7)
  m.build((5, 6))
  q = torch.from_numpy(_x(17, 2, 5, 6)).requires_grad_()
  k = torch.from_numpy(_x(18, 2, 7, 6))
  ctx, w = m(q, k, generator=torch.Generator().manual_seed(seed))
  return m, q, k, ctx, w


@pytest.mark.parametrize("align", ["relaxed", "hard"])
def test_sampling_alignments_are_distributions(align):
  _, _, _, ctx, w = _sampling(align)
  w = w.detach().numpy()
  np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-5)
  assert np.all(w >= -1e-7)
  if align == "hard":
    np.testing.assert_allclose(np.sort(w, -1)[..., -1], 1.0, atol=1e-6)
    np.testing.assert_allclose(np.sort(w, -1)[..., :-1], 0.0, atol=1e-6)
  assert ctx.shape == (2, 5, 6)


@pytest.mark.parametrize("align", ["relaxed", "hard"])
def test_sampling_is_seeded_by_the_generator(align):
  w0 = _sampling(align, seed=3)[4].detach()
  w1 = _sampling(align, seed=3)[4].detach()
  w2 = _sampling(align, seed=4)[4].detach()
  assert torch.equal(w0, w1)
  assert not torch.equal(w0, w2)


def test_hard_straight_through_gradient_is_the_softmax_gradient():
  m, q, k, _, w = _sampling("hard")
  c = torch.from_numpy(_x(19, 2, 5, 7))
  (gq,) = torch.autograd.grad((w * c).sum(), q)
  soft = ta.Attention(temperature=0.7)
  soft.build((5, 6))
  _, ws = soft(q, k)
  (gs,) = torch.autograd.grad((ws * c).sum(), q)
  np.testing.assert_allclose(gq.numpy(), gs.numpy(), atol=1e-6)
  assert gq.abs().max() > 0


def test_hard_reinforce_is_the_one_hot_sample_in_value():
  _, q, _, _, w = _sampling("hard", "reinforce", seed=5)
  _, _, _, _, w_st = _sampling("hard", "st", seed=5)
  np.testing.assert_allclose(w.detach().numpy(), w_st.detach().numpy(),
                             atol=1e-6)
  (g,) = torch.autograd.grad(w.sum(), q)
  assert torch.isfinite(g).all()


def test_sampling_needs_a_generator():
  m = ta.Attention(align="hard")
  m.build((5, 6))
  with pytest.raises(ValueError, match="Generator"):
    m(torch.zeros(1, 5, 6))


def test_mechanism_flags_to_fields_match_jax():
  for name in ("ScoreAdditive", "ScoreCosine", "LocalP", "Hard", "Relax"):
    flags = ta.AttentionMechanism[name] | ta.AttentionMechanism.LocalM
    assert flags.to_fields() == ja.AttentionMechanism(int(flags)).to_fields()


@pytest.mark.parametrize("heads,depth", [(3, 1), (3, 2), (1, 2), (2, 0)])
def test_attention_heads_match_jax(heads, depth):
  x = _x(20, 2, 5, 8)
  jm = ja.create_attention_heads(8, num_heads=heads, depth=depth)
  tm = ta.create_attention_heads(8, num_heads=heads, depth=depth)
  variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
  params = jax.device_get(variables.get("params", {}))
  shape = tm.build((5, 8))
  tm.load_state_dict(from_jax_params(params), strict=True)
  want = np.asarray(jm.apply(variables, jnp.asarray(x)))
  with torch.no_grad():
    got = tm(torch.from_numpy(x)).numpy()
  assert got.shape == want.shape
  # build's shape leaves out the batch axis: axis 1 of (H, B, T, d)
  assert shape == (want.shape[:1] + want.shape[2:] if want.ndim == 4 else
                   want.shape[1:])
  np.testing.assert_allclose(got, want, atol=ATOL)


def test_mha_build_puts_the_layer_on_the_card_by_default(monkeypatch):
  """As the port's other entry points: the card unless the caller asks for
  the CPU; with no card the default raises instead of staying on the CPU."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    ta.MultiHeadAttention(num_heads=2, flash=True).build((4, 8))
  m = ta.MultiHeadAttention(num_heads=2, flash=True)
  m.build((4, 8), device="cpu")
  assert {p.device.type for p in m.parameters()} == {"cpu"}
