"""The port's training state and its bridge to the JAX package, on the CPU
(the optimizer alone: tests/test_torch_optimizer.py).

  * Whole steps with an EMA and a learning-rate schedule, and a state
    resumed from JAX's, on the full-width dSprites beta-VAE at batch 4: the limits of tests/test_torch_training.py (losses rtol 1e-4,
    params and the EMA by ``assert_params_close``).
  * ``TrainState`` carried JAX -> port -> JAX: exact.
"""
import numpy as np
import pytest
import torch

import jax

from odin_tpu.networks import get_optimizer_info as jax_optimizer_info
from odin_tpu.training.core import EMA_KEY as JAX_EMA_KEY
from odin_tpu_torch.networks import get_optimizer_info
from odin_tpu_torch.training import EMA_KEY, use_ema_params
from odin_tpu_torch.weights import from_jax_state, to_jax_state
from torch_training_common import (assert_params_close, binary_images,
                                   make_pair, np_tree, port_tree, step_noise)

torch.set_num_threads(2)

RTOL = 1e-4
B = 4


@pytest.fixture(scope="module")
def pair():
  return make_pair(beta=1.0)


@pytest.fixture(scope="module")
def ema_run(pair):
  """Two steps with ema_decay 0.9 and dsprites' learning-rate schedule in
  both packages, then one more from the JAX state carried to the port
  (keep_opt_states)."""
  jvae, vae = pair
  start = (jvae.state, vae.state)
  lr_j = jax_optimizer_info("dsprites")["learning_rate"]
  lr = get_optimizer_info("dsprites")["learning_rate"]
  jstep = jax.jit(jvae.make_step_fn(learning_rate=lr_j, ema_decay=0.9,
                                    jit=False))
  step = vae.make_step_fn(learning_rate=lr, ema_decay=0.9)
  js, s = jvae.state, vae.state
  rng = js.rng
  for i in range(2):
    x = binary_images(B, 70 + i)
    rng, eps = step_noise(rng, B)
    js, jm = jstep(js, x)
    s, m = step(s, x, eps=torch.from_numpy(eps))
  js = jax.device_get(js)
  jvae.state, vae.state = start
  return js, s, rng


def test_ema_and_schedule_match_jax(ema_run):
  js, s, _ = ema_run
  for tree_j, tree in ((js.params, s.params),
                       (js.opt_states[JAX_EMA_KEY], s.opt_states[EMA_KEY])):
    assert_params_close(np_tree(tree)["vae"], port_tree(tree_j)["vae"], 2)
  assert int(s.opt_states["vae"]["lr_count"]) == \
      int(js.opt_states["vae"][1].count) == 2
  ema = use_ema_params(s)
  assert ema.params is s.opt_states[EMA_KEY]


def test_train_state_round_trip_is_exact(ema_run):
  """JAX -> port -> JAX keeps every leaf: params, Adam's count and
  moments, the schedule's count, the EMA tree, step, skipped_updates."""
  js, _, _ = ema_run
  state = from_jax_state(js, device="cpu")
  assert set(state.opt_states["vae"]) == {"count", "mu", "nu", "lr_count"}
  back = to_jax_state(state, js)
  flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
  want, got = flat(js), flat(back)
  assert [p for p, _ in want] == [p for p, _ in got]
  for (path, w), (_, g) in zip(want, got):
    w, g = np.asarray(w), np.asarray(g)
    assert w.dtype == g.dtype, path
    np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


def test_keep_opt_states_resumes_a_jax_state(pair, ema_run):
  """A state carried from JAX resumes in the port: one more step from the
  same moments, count and schedule count as JAX's next step."""
  jvae, vae = pair
  js, _, rng = ema_run
  start = (jvae.state, vae.state)
  lr_j = jax_optimizer_info("dsprites")["learning_rate"]
  lr = get_optimizer_info("dsprites")["learning_rate"]
  jvae.state = js
  jstep = jax.jit(jvae.make_step_fn(learning_rate=lr_j, keep_opt_states=True,
                                    jit=False))
  vae.state = from_jax_state(js, device="cpu")
  step = vae.make_step_fn(learning_rate=lr, keep_opt_states=True)
  x = binary_images(B, 80)
  _, eps = step_noise(rng, B)
  js2, jm = jstep(jvae.state, x)
  s2, m = step(vae.state, x, eps=torch.from_numpy(eps))
  jvae.state, vae.state = start
  np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=RTOL)
  assert_params_close(np_tree(s2.params)["vae"],
                      port_tree(jax.device_get(js2.params))["vae"], 1)
  assert int(s2.opt_states["vae"]["count"]) == 3
  assert int(s2.opt_states["vae"]["lr_count"]) == 3
  assert int(s2.step) == int(js2.step) == 3
