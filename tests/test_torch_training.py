"""The port's beta-VAE training step against the JAX package on the CPU
(the ELBO and its gradient alone: tests/test_torch_elbo.py).

The full-width dSprites model (conv 32-32-64-64, proj 128, zdim 10) at
batch 4: both packages start from the same params, see the same binary
images and the same noise (the JAX package's draws replayed from its keys,
tests/torch_training_common.py).  Limits, float32 convolutions summed in
another order on each side:

  * ELBO terms and losses: rtol 1e-4 (a sum over 4,096 pixels);
  * gradients and Adam moments: 1e-4·max|JAX| of each tensor, beside
    rtol 1e-4;
  * params after the steps: ``assert_params_close`` (atol 1e-5, 1 % of one
    Adam step at lr 1e-3, for all but 2e-5 of the elements, and 2·lr a
    step for every element; tests/torch_training_common.py says why);
  * counts (``step``, ``skipped_updates``, Adam's ``count``): exact.
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from odin_tpu.training.core import device_dataset_steps as jax_dataset_steps
from odin_tpu_torch.bay.vi import BetaVAE
from odin_tpu_torch.networks import get_networks
from odin_tpu_torch.training import core as training_core
from odin_tpu_torch.training import device_dataset_steps, scan_steps
from torch_training_common import (assert_params_close, binary_images,
                                   make_pair, np_tree, port_tree, step_noise)

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


@pytest.fixture(scope="module")
def three_steps(pair):
  """Three Adam steps through both packages from the same state."""
  jvae, vae = pair
  jstep = jax.jit(jvae.make_step_fn(learning_rate=1e-3, jit=False))
  step = vae.make_step_fn(learning_rate=1e-3)
  js, s = jvae.state, vae.state
  start = (js, s)
  rng, out = js.rng, []
  for i in range(3):
    x = binary_images(B, i)
    rng, eps = step_noise(rng, B)
    js, jm = jstep(js, x)
    s, m = step(s, x, eps=torch.from_numpy(eps))
    out.append((jax.device_get(jm), m, x, eps))
  return start, jax.device_get(js), s, out


def test_three_steps_match_jax(three_steps):
  start, js, s, out = three_steps
  for jm, m, _, _ in out:
    assert set(m) == set(jm) == {"loss", "llk_image", "kl_latents"}
    for k in jm:
      np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL)
  assert_params_close(np_tree(s.params)["vae"],
                      port_tree(js.params)["vae"], 3)
  adam = js.opt_states["vae"][0]
  for name in ("mu", "nu"):
    _close_tree(np_tree(s.opt_states["vae"][name])["vae"],
                {k: v.numpy() for k, v in
                 port_tree(getattr(adam, name))["vae"].items()})
  assert int(s.opt_states["vae"]["count"]) == int(adam.count) == 3
  assert int(s.step) == int(js.step) == 3
  assert int(s.skipped_updates) == int(js.skipped_updates) == 0
  assert s.step.dtype == s.skipped_updates.dtype == torch.int32
  # the step is pure: the state it started from is as it was
  want0 = port_tree(jax.device_get(start[0].params))["vae"]
  for k, v in start[1].params["vae"].items():
    np.testing.assert_array_equal(v.numpy(), want0[k].numpy(), err_msg=k)


def test_nan_skip_and_stop_match_jax(pair, three_steps):
  """A batch holding a NaN: 'stop' (JAX and port) and 'skip' (port) keep
  every param and moment bitwise, leave Adam's count where it was, advance
  ``step`` and count the skip; 'stop' reports it in the metrics."""
  jvae, vae = pair
  start, _, _, out = three_steps
  jvae.state, vae.state = start
  jstep = jax.jit(jvae.make_step_fn(learning_rate=1e-3, nan_policy="stop",
                                    jit=False))
  bad = binary_images(B, 20)
  bad[1, 5, 7, 0] = np.nan
  batches = [out[0][2], bad, out[2][2]]
  epss = [out[0][3], out[1][3], out[2][3]]
  js, jflags = jvae.state, []
  for x in batches:
    js, jm = jstep(js, x)
    jflags.append(float(jm["nan_gradients"]))
  assert jflags == [0.0, 1.0, 0.0]
  for policy in ("stop", "skip"):
    vae.state = start[1]
    step = vae.make_step_fn(learning_rate=1e-3, nan_policy=policy)
    s, flags = vae.state, []
    for i, (x, eps) in enumerate(zip(batches, epss)):
      before = s
      s, m = step(s, x, eps=torch.from_numpy(eps))
      assert ("nan_gradients" in m) == (policy == "stop")
      flags.append(float(m.get("nan_gradients", -1)))
      if i == 1:
        assert not np.isfinite(float(m["loss"]))
        for k, v in before.params["vae"].items():
          assert torch.equal(s.params["vae"][k], v), k
        for name in ("mu", "nu"):
          for k, v in before.opt_states["vae"][name]["vae"].items():
            assert torch.equal(s.opt_states["vae"][name]["vae"][k], v)
    if policy == "stop":
      assert flags == jflags
    assert int(s.skipped_updates) == int(js.skipped_updates) == 1
    assert int(s.opt_states["vae"]["count"]) == \
        int(js.opt_states["vae"][0].count) == 2
    assert int(s.step) == int(js.step) == 3
    assert_params_close(np_tree(s.params)["vae"],
                        port_tree(jax.device_get(js.params))["vae"], 3)


def test_apply_policy_applies_non_finite_updates(pair, three_steps):
  _, vae = pair
  start, _, _, out = three_steps
  vae.state = start[1]
  step = vae.make_step_fn(learning_rate=1e-3, nan_policy="apply")
  bad = binary_images(B, 20)
  bad[0, 0, 0, 0] = np.nan
  s, m = step(vae.state, bad, eps=torch.from_numpy(out[0][3]))
  assert "nan_gradients" not in m
  assert int(s.skipped_updates) == 0
  assert not torch.isfinite(s.params["vae"]["encoder.layers.1.weight"]).all()


def test_scan_steps_on_cpu_equal_single_steps(pair, three_steps):
  """On the CPU, scan_steps is a loop of the same step: equal bitwise,
  and it returns the last step's metrics."""
  _, vae = pair
  start, _, s_one, out = three_steps
  vae.state = start[1]
  step = vae.make_step_fn(learning_rate=1e-3)
  fused = scan_steps(step, 3)
  batches = np.stack([o[2] for o in out])
  eps = np.stack([o[3] for o in out])
  s, m = fused(vae.state, batches, eps=torch.from_numpy(eps))
  for k, v in s_one.params["vae"].items():
    assert torch.equal(s.params["vae"][k], v), k
  assert float(m["loss"]) == float(out[-1][1]["loss"])
  assert int(s.step) == 3
  with pytest.raises(ValueError):
    fused(vae.state, batches[:2])
  with pytest.raises(ValueError):
    scan_steps(step, 3, graph=True)(vae.state, batches)


def test_device_dataset_steps_match_jax(pair, three_steps):
  """Batches gathered on the device from a uint8 corpus: the port, fed the
  indices and noise replayed from the JAX package's keys
  (``randint(fold_in(PRNGKey(seed), step), ...)``), reaches JAX's params."""
  jvae, vae = pair
  start, _, _, _ = three_steps
  jvae.state, vae.state = start
  corpus = (binary_images(24, 30) * 255).astype(np.uint8)
  n_steps, seed = 2, 5
  jfused = jax.jit(jax_dataset_steps(
      jvae.make_step_fn(learning_rate=1e-3, jit=False), B, n_steps, seed))
  js, jm = jfused(jvae.state, jnp.asarray(corpus))
  js = jax.device_get(js)
  key = jax.random.PRNGKey(seed)
  idx = np.stack([np.asarray(jax.random.randint(
      jax.random.fold_in(key, s), (B,), 0, len(corpus)))
      for s in range(n_steps)])
  rng, epss = jvae.state.rng, []
  for _ in range(n_steps):
    rng, eps = step_noise(rng, B)
    epss.append(eps)
  fused = device_dataset_steps(vae.make_step_fn(learning_rate=1e-3), B,
                               n_steps, seed=seed)
  s, m = fused(vae.state, torch.from_numpy(corpus),
               indices=torch.from_numpy(idx),
               eps=torch.from_numpy(np.stack(epss)))
  np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=RTOL)
  assert_params_close(np_tree(s.params)["vae"], port_tree(js.params)["vae"],
                      n_steps)
  assert int(s.step) == n_steps
  # drawn on the device: indices from the fused step's own generator
  s2, m2 = fused(vae.state, torch.from_numpy(corpus))
  assert int(s2.step) == n_steps and np.isfinite(float(m2["loss"]))


def test_device_dataset_steps_take_a_sample_fn(pair, three_steps):
  """`sample_fn(generator, data)` in place of the uniform gather: fed the
  three steps' batches in order, the steps equal the single steps."""
  _, vae = pair
  start, _, s_one, out = three_steps
  vae.state = start[1]
  step = vae.make_step_fn(learning_rate=1e-3)
  data = torch.from_numpy(np.stack([o[2] for o in out]))
  generators = []

  def sample_fn(generator, d):
    generators.append(generator)
    return d[len(generators) - 1]

  fused = device_dataset_steps(step, B, 3, sample_fn=sample_fn)
  s, _ = fused(vae.state, data,
               eps=torch.from_numpy(np.stack([o[3] for o in out])))
  assert len(generators) == 3
  assert all(isinstance(g, torch.Generator) for g in generators)
  for k, v in s_one.params["vae"].items():
    assert torch.equal(s.params["vae"][k], v), k


@pytest.fixture
def rehearsed_graph(monkeypatch):
  """The graphed path's static-buffer logic on the CPU: a stand-in for the
  CUDA graph whose replay runs the captured step's body again."""

  def capture(self, state, inputs, body, generators):
    self.state = training_core._clone_state(state)
    self.inputs = {k: v.clone() for k, v in inputs.items()}
    self.slot = torch.zeros(1, dtype=torch.int64)

    def replay():
      self._metrics = self._one_step(body)

    self._graph, self._metrics = types.SimpleNamespace(replay=replay), {}
    self.capture_seconds = 0.0

  monkeypatch.setattr(training_core._StepGraph, "_capture", capture)
  monkeypatch.setattr(training_core, "_use_graph", lambda graph, state: True)


def test_graphed_steps_keep_a_held_state(pair, three_steps, rehearsed_graph):
  """Through the graphed path's buffers the steps equal the single steps,
  and a state a call returned keeps its values when the next call runs
  (the JAX package's k-step functions do not donate their input)."""
  _, vae = pair
  start, _, s_one, out = three_steps
  step = vae.make_step_fn(learning_rate=1e-3)
  vae.state = start[1]
  batches = torch.from_numpy(np.stack([o[2] for o in out]))
  eps = torch.from_numpy(np.stack([o[3] for o in out]))
  fused = scan_steps(step, 3)
  s1, m1 = fused(vae.state, batches, eps=eps)
  for k, v in s_one.params["vae"].items():
    assert torch.equal(s1.params["vae"][k], v), k
  assert float(m1["loss"]) == float(out[-1][1]["loss"])
  held = {k: v.clone() for k, v in s1.params["vae"].items()}
  held_mu = {k: v.clone() for k, v in s1.opt_states["vae"]["mu"]["vae"].items()}
  s2, _ = fused(s1, batches, eps=eps)
  assert int(s1.step) == 3 and int(s2.step) == 6
  assert int(s1.opt_states["vae"]["count"]) == 3
  for k, v in held.items():
    assert torch.equal(s1.params["vae"][k], v), k
    assert not torch.equal(s2.params["vae"][k], v), k
  for k, v in held_mu.items():
    assert torch.equal(s1.opt_states["vae"]["mu"]["vae"][k], v), k
  # device_dataset_steps shares the runner: its graphed path equals its
  # eager one on the same indices and noise
  corpus = (binary_images(12, 31) * 255).astype(np.uint8)
  idx = torch.from_numpy(np.random.RandomState(2).randint(0, 12, (3, B)))
  runs = [device_dataset_steps(step, B, 3, graph=graph)(
      vae.state, torch.from_numpy(corpus), indices=idx, eps=eps)
      for graph in (False, None)]
  (s_e, m_e), (s_g, m_g) = runs
  for k, v in s_e.params["vae"].items():
    assert torch.equal(s_g.params["vae"][k], v), k
  assert float(m_g["loss"]) == float(m_e["loss"])


def test_loaded_weights_reach_the_trained_model(pair, three_steps):
  """``vae.state`` is the one source of the params: after a training step,
  ``core.load_state_dict`` writes through to it (reconstruct serves the
  loaded weights) and ``core.state_dict()`` reads it."""
  _, vae = pair
  start, s_jax, s_one, _ = three_steps
  other = BetaVAE(beta=1.0, **get_networks("dsprites", zdim=10)).build(
      seed=7, device="cpu")
  vae.state = s_one
  sd = vae.core.state_dict()
  for k, v in s_one.params["vae"].items():
    assert torch.equal(sd[k], v), k
  x = binary_images(2, 40)
  try:
    vae.core.load_state_dict(other.core.state_dict(), strict=True)
    qz, px = vae.reconstruct(x)
    want_qz, want_px = other.reconstruct(x)
    assert torch.equal(qz.mean(), want_qz.mean())
    assert torch.equal(px.mean(), want_px.mean())
    assert int(vae.state.step) == 3
    for k, v in s_one.params["vae"].items():  # the held state is unchanged
      assert not torch.equal(vae.state.params["vae"][k], v), k
  finally:
    vae.state = start[1]
