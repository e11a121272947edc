"""Options of the port's training step against the JAX package on the CPU:
gradient accumulation, rematerialisation and a frozen encoder
(`train_params`), on the full-width dSprites
beta-VAE at batch 4 (see tests/test_torch_training.py for the set-up and
the float32 limits: losses rtol 1e-4, params after the steps by
``assert_params_close``, whose rule tests/torch_training_common.py
states).  bf16 compute and clipping: tests/test_torch_training_precision.py.
"""
import numpy as np
import pytest
import torch

import jax

from torch_training_common import (assert_params_close, binary_images,
                                   check_run, make_pair, np_tree, port_tree,
                                   run_both, step_noise)

torch.set_num_threads(2)

RTOL = 1e-4
B = 4
LR = 1e-3


@pytest.fixture(scope="module")
def pair():
  return make_pair(beta=1.0)


def test_accum_steps_match_jax(pair):
  """Two microbatches of 2, their gradients averaged before one update."""
  check_run(*run_both(pair, accum_steps=2))


def test_accum_steps_equal_one_full_batch(pair):
  """With the same noise, two microbatches give the full batch's step
  (the loss is a mean over the batch); float32 sums in another order,
  1e-5 as tests/test_vae_core.py::test_grad_accumulation_matches_full_batch."""
  _, vae = pair
  start = vae.state
  x = binary_images(B, 50)
  eps = np.random.RandomState(0).randn(B, 10).astype(np.float32)
  full = vae.make_step_fn(learning_rate=LR)
  s1, m1 = full(vae.state, x, eps=torch.from_numpy(eps))
  acc = vae.make_step_fn(learning_rate=LR, accum_steps=2)
  s2, m2 = acc(vae.state, x, eps=torch.from_numpy(eps.reshape(2, 2, 10)))
  vae.state = start
  np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                             rtol=1e-5, atol=1e-5)
  for k, v in s1.params["vae"].items():
    np.testing.assert_allclose(s2.params["vae"][k].numpy(), v.numpy(),
                               rtol=1e-5, atol=1e-5, err_msg=k)


def test_remat_equals_plain(pair):
  """Recomputing the forward in the backward (the same noise replayed)
  gives the plain step's gradients: 1e-6."""
  _, vae = pair
  start = vae.state
  x = binary_images(B, 60)
  eps = torch.from_numpy(np.random.RandomState(1).randn(B, 10).astype("f"))
  outs = []
  for remat in (False, True):
    step = vae.make_step_fn(learning_rate=LR, remat=remat)
    loss, _, g = step.value_and_grad(vae.state, x, eps=eps)
    s, _ = step(vae.state, x, eps=eps)
    outs.append((float(loss), np_tree(g)["vae"], np_tree(s.params)["vae"]))
    vae.state = start
  # with the generator instead of eps: the recomputed forward must see the
  # draw of the first one
  gen_grads = []
  for remat in (False, True):
    step = vae.make_step_fn(learning_rate=LR, remat=remat)
    state = vae.state.replace(rng=torch.Generator().manual_seed(3))
    gen_grads.append(np_tree(step.value_and_grad(state, x)[2])["vae"])
    vae.state = start
  (l0, g0, p0), (l1, g1, p1) = outs
  assert l0 == pytest.approx(l1, rel=1e-6)
  for k in g0:
    np.testing.assert_allclose(g1[k], g0[k], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p1[k], p0[k], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gen_grads[1][k], gen_grads[0][k], rtol=1e-6,
                               atol=1e-6)


def test_remat_policy_names_raise(pair):
  """A name that is not one of the policies raises ``ValueError`` listing
  them; a policy's name builds the step (tests/test_torch_remat.py holds
  each against the plain step)."""
  _, vae = pair
  start = vae.state
  with pytest.raises(ValueError, match="dots_with_no_batch_dims_saveable"):
    vae.make_step_fn(remat="dots_with_no_batch_saveable")
  assert vae.make_step_fn(remat="dots_with_no_batch_dims_saveable").remat
  vae.state = start


def test_frozen_encoder_matches_jax(pair):
  """train_params=('vae/decoder',): only the decoder moves, as in JAX."""
  jvae, vae = pair
  start = (jvae.state, vae.state)
  jstep = jax.jit(jvae.make_step_fn(train_params=("vae/decoder",),
                                    jit=False))
  step = vae.make_step_fn(train_params=("vae/decoder",))
  assert set(vae.state.opt_states["vae/decoder"]["mu"]) == {"vae/decoder"}
  x = binary_images(B, 90)
  _, eps = step_noise(jvae.state.rng, B)
  js, jm = jstep(jvae.state, x)
  s, m = step(vae.state, x, eps=torch.from_numpy(eps))
  np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=RTOL)
  assert_params_close(np_tree(s.params)["vae"],
                      port_tree(jax.device_get(js.params))["vae"], 1)
  for k in s.params["vae"]:
    moved = not torch.equal(s.params["vae"][k], start[1].params["vae"][k])
    assert moved == k.startswith("decoder."), k
  jvae.state, vae.state = start
