"""The port's ELBO, its gradient, its evaluation function and the
model's sampling methods against the JAX package on the CPU.

The full-width dSprites model (conv 32-32-64-64, proj 128, zdim 10) at
batch 4: both packages start from the same params, see the same binary
images and the same noise (the JAX package's draws replayed from its key,
tests/torch_training_common.py).  Limits, float32 convolutions summed in
another order on each side: ELBO terms and losses rtol 1e-4 (a sum over
4,096 pixels); gradients 1e-4·max|JAX| of each tensor, beside rtol 1e-4.
"""
import numpy as np
import pytest
import torch

import jax

from torch_training_common import (binary_images, make_pair, np_tree,
                                   port_tree)

torch.set_num_threads(2)

RTOL = 1e-4
GRAD_REL = 1e-4
B = 4


def _close_tree(got, want, rel=GRAD_REL, rtol=RTOL):
  assert set(got) == set(want)
  for k in want:
    w = np.asarray(want[k])
    np.testing.assert_allclose(np.asarray(got[k]), w, rtol=rtol,
                               atol=rel * float(np.abs(w).max()) + 1e-12,
                               err_msg=k)


@pytest.fixture(scope="module")
def pair():
  return make_pair(beta=1.0)


def test_elbo_components_match_jax(pair):
  jvae, vae = pair
  x = binary_images(B, 10)
  key = jax.random.PRNGKey(7)
  eps = np.array(jax.random.normal(jax.random.split(key)[1], (B, 10)))
  jllk, jkl = jax.jit(lambda p: jvae.elbo_components(p, x, key, 0)[:2])(
      jvae.state.params)
  llk, kl, aux = vae.elbo_components(vae.state.params, torch.from_numpy(x),
                                     torch.from_numpy(eps), 0)
  assert set(llk) == set(jllk) == {"llk_image"}
  assert set(kl) == set(jkl) == {"kl_latents"}
  assert tuple(aux["z"].shape) == (B, 10)
  for got, want in ((llk, jllk), (kl, jkl)):
    for k in want:
      np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                 rtol=RTOL)


def test_sample_shape_elbo_matches_jax():
  """Two posterior samples per image: the llk averaged over them, the MC
  KL averaged over its leading sample axis."""
  jvae, vae = make_pair(beta=1.0, sample_shape=2)
  x = binary_images(B, 11)
  key = jax.random.PRNGKey(8)
  eps = np.array(jax.random.normal(jax.random.split(key)[1], (2, B, 10)))
  jllk, jkl = jax.jit(lambda p: jvae.elbo_components(p, x, key, 0)[:2])(
      jvae.state.params)
  llk, kl, _ = vae.elbo_components(vae.state.params, torch.from_numpy(x),
                                   torch.from_numpy(eps), 0)
  np.testing.assert_allclose(llk["llk_image"].numpy(),
                             np.asarray(jllk["llk_image"]), rtol=RTOL)
  np.testing.assert_allclose(kl["kl_latents"].numpy(),
                             np.asarray(jkl["kl_latents"]), rtol=RTOL)
  assert tuple(kl["kl_latents"].shape) == (B,)


def test_vae_loss_and_gradients_match_jax(pair):
  jvae, vae = pair
  x = binary_images(B, 12)
  key = jax.random.PRNGKey(9)
  eps = np.array(jax.random.normal(jax.random.split(key)[1], (B, 10)))

  def jloss(p):
    return jvae._vae_loss({"vae": p}, x, key, 0, {})

  (jl, (jm, _)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
      jvae.state.params["vae"])
  step = vae.make_step_fn()
  loss, metrics, grads = step.value_and_grad(vae.state, x,
                                             eps=torch.from_numpy(eps))
  np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
  for k in jm:
    np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=RTOL)
  _close_tree(np_tree(grads)["vae"],
              port_tree({"vae": jax.device_get(jg)})["vae"])


def test_eval_fn_matches_jax(pair):
  jvae, vae = pair
  x = binary_images(B, 95)
  jm = jax.jit(jvae.make_eval_fn(jit=False))(jvae.state, x)
  eps = np.array(jax.random.normal(
      jax.random.split(jax.random.PRNGKey(0))[1], (B, 10)))
  m = vae.make_eval_fn()(vae.state, x, eps=torch.from_numpy(eps))
  assert set(m) == set(jm)
  for k in jm:
    np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL)
  drawn = vae.make_eval_fn()(vae.state, x)
  assert np.isfinite(float(drawn["loss"]))


def test_sampling_methods(pair):
  _, vae = pair
  z = vae.sample_prior(6, seed=3)
  assert tuple(z.shape) == (6, 10)
  assert torch.equal(z, vae.sample_prior(6, seed=3))
  px = vae.sample_observation(2, seed=1)
  assert tuple(px.mean().shape) == (2, 64, 64, 1)
  px, qz = vae(binary_images(3, 1), seed=2)
  assert tuple(px.mean().shape) == (3, 64, 64, 1)
  assert tuple(qz.mean().shape) == (3, 10)
