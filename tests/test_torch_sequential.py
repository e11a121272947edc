"""The port's sequential family (VariationalRNN, SequentialVAE,
SequentialAttentionVAE) and its GRU cell against the JAX package on the
CPU, at T = 5 steps of 6 features, 8 recurrent and feature units, latents
of 3 and a static latent of 2.  Both packages on the same params (the GRU
gates fused by ``to_jax_params``/``from_jax_params``); JAX's draws,
those inside its ``nn.scan`` bodies included, recorded in order through
``jit_with_scan_draws`` and replayed.  The ELBO terms within rtol 1e-5,
three Adam steps, the flax trees against the JAX inits, decode and
generate."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odin_tpu.bay.vi as jax_vi
import odin_tpu_torch.bay.vi as port_vi
from odin_tpu.bay.random_variable import RVconf as JaxRVconf
from odin_tpu_torch.bay.random_variable import RVconf
from odin_tpu_torch.networks import GRUCell
from odin_tpu_torch.training.core import Noise
from odin_tpu_torch.weights import from_jax_params, to_jax_params
from torch_zoo_common import (assert_tree_matches_jax_init, elbo_matches_jax,
                              jax_state_of, jit_with_scan_draws,
                              steps_match_jax, to_torch)

torch.set_num_threads(2)

T, D, H, B = 5, 6, 8, 4
CLASSES = {
    "VariationalRNN": dict(rnn_units=H, feature_units=H, zdim=3),
    "SequentialVAE": dict(rnn_units=H, feature_units=H, fdim=2, zdim=3),
    "SequentialAttentionVAE": dict(rnn_units=H, attn_beta=0.5, zdim=3),
}


def seq_pair(cls, seed=1):
  kw = dict(CLASSES[cls])
  zdim = kw.pop("zdim")
  vae = getattr(port_vi, cls)(
      latents=RVconf(zdim, "mvndiag", projection=True, name="latents"),
      input_shape=(T, D), **kw).build(seed=seed, device="cpu")
  jvae = getattr(jax_vi, cls)(
      latents=JaxRVconf(zdim, "mvndiag", projection=True, name="latents"),
      input_shape=(T, D), **kw)
  jvae.state = jax_state_of(vae, seed)
  return jvae, vae


def sequences(seed, n=B):
  return np.random.RandomState(seed).randn(n, T, D).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CLASSES))
def pair(request):
  return request.param, seq_pair(request.param)


def test_gru_cell_matches_flax():
  """One step of flax's ``nn.GRUCell`` on its own init, carried into the
  port's cell, and a scan of 5 steps."""
  cell = fnn.GRUCell(H)
  x = np.random.RandomState(0).randn(3, 5, D).astype(np.float32)
  h0 = np.random.RandomState(1).randn(3, H).astype(np.float32)
  params = cell.init(jax.random.PRNGKey(0), jnp.asarray(h0),
                     jnp.asarray(x[:, 0]))["params"]
  port = GRUCell(H)
  port.build((D,))
  port.load_state_dict(from_jax_params(params))
  h_jax, h = jnp.asarray(h0), torch.from_numpy(h0)
  w = port.weights()
  for t in range(5):
    h_jax, _ = cell.apply({"params": params}, h_jax, jnp.asarray(x[:, t]))
    h = port(h, torch.from_numpy(x[:, t]), w)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_jax),
                               rtol=1e-5, atol=1e-6, err_msg=f"step {t}")
  back = to_jax_params(port)
  assert jax.tree_util.tree_structure(back) == \
      jax.tree_util.tree_structure(jax.device_get(params))
  for a, b in zip(jax.tree_util.tree_leaves(back),
                  jax.tree_util.tree_leaves(jax.device_get(params))):
    np.testing.assert_array_equal(a, b)
  # the r and z gates have no hidden bias: a zero in the fused vector
  assert not bool(w[3][:2 * H].any())


def test_elbo_terms_match_jax(pair):
  _, p = pair
  elbo_matches_jax(p, sequences(1), steps=(0,), recorder=jit_with_scan_draws)


def test_three_adam_steps_match_jax(pair):
  _, p = pair
  steps_match_jax(p, [sequences(10 + i) for i in range(3)],
                  recorder=jit_with_scan_draws)


def test_flax_tree_matches_jax_init(pair):
  _, (jvae, vae) = pair
  assert_tree_matches_jax_init(jvae, vae, jnp.zeros((1, T, D)))


def test_draws_follow_the_steps(pair):
  """JAX's scan makes one draw a step where the port's loop does: the
  recorded draws have the shapes the port asks for, in order."""
  cls, (jvae, vae) = pair
  fn = jit_with_scan_draws(lambda p, b, k: jvae.elbo_components(
      p, b, k, 0)[:2])
  _, draws = fn(jvae.state.params, sequences(2), jax.random.PRNGKey(0))
  shapes = [tuple(d.shape) for d in draws]
  want = {"VariationalRNN": [(B, 3)] * T,
          "SequentialVAE": [(B, 2), (B, T, 3)],
          "SequentialAttentionVAE": [(B, 3)] + [(B, H)] * T}[cls]
  assert shapes == want
  noise = Noise(eps=to_torch(draws))
  vae.elbo_components(vae.state.params, torch.from_numpy(sequences(2)),
                      noise, 0)
  assert noise.mark() == len(draws)


@pytest.mark.parametrize("cls", ["VariationalRNN", "SequentialVAE"])
def test_decode_matches_jax(cls):
  """The closed-loop decode from given latents (VRNN), the emission of
  given dynamic latents (DSA): no draws, so both packages' own (SAVAE's
  decode draws its contexts: ``test_attention_decode_draws_per_step``)."""
  jvae, vae = seq_pair(cls)
  z = np.random.RandomState(3).randn(B, T, 3).astype(np.float32)
  got = vae.decode(z).mean().numpy()
  want = np.asarray(jvae.decode(z).mean())
  np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
  assert got.shape == (B, T, D)


def test_attention_decode_draws_per_step():
  jvae, vae = seq_pair("SequentialAttentionVAE")
  z = np.random.RandomState(3).randn(B, 3).astype(np.float32)
  fn = jit_with_scan_draws(lambda p, zz, k: jvae._apply(p, "decode", zz,
                                                        rng=k))
  want, draws = fn(jvae.state.params, z, jax.random.PRNGKey(1))
  assert [tuple(d.shape) for d in draws] == [(B, H)] * T
  got = vae._apply(vae.state.params, "decode", torch.from_numpy(z),
                   noise=Noise(eps=to_torch(draws)))
  np.testing.assert_allclose(got.mean().numpy(), np.asarray(want.mean()),
                             rtol=1e-5, atol=1e-6)


def test_vrnn_generates_from_its_prior():
  jvae, vae = seq_pair("VariationalRNN")
  fn = jit_with_scan_draws(lambda p, k: jvae.generate(3, 4, params=p, rng=k))
  (jpx, jz), draws = fn(jvae.state.params, jax.random.PRNGKey(2))
  px, z = vae._apply(vae.state.params, "generate", torch.zeros(3, 4, 1),
                     noise=Noise(eps=to_torch(draws)))
  np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5, atol=1e-6)
  np.testing.assert_allclose(px.mean().numpy(), np.asarray(jpx.mean()),
                             rtol=1e-5, atol=1e-6)
  px, z = vae.generate(2, seed=0)
  assert z.shape == (2, T, 3) and px.mean().shape == (2, T, D)
