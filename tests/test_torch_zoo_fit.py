"""The zoo through the port's k-steps-per-call path on the CPU: the CUDA
graph's static-buffer logic rehearsed (the ``rehearsed_graph`` stand-in of
tests/test_torch_training.py, whose replay runs the captured step again)
for models with two optimizers (FactorVAE), mutables moved in the step
(VQ-VAE's EMA codebook with restarts) and the vMF sampler
(HypersphericalVAE): the graphed steps equal the eager ones exactly, a
state a call returned keeps its values, and ``fit`` trains each."""
import types

import numpy as np
import pytest
import torch

from odin_tpu_torch.training import core as training_core
from odin_tpu_torch.training.core import _state_leaves, scan_steps
from torch_zoo_common import B, binary_images, make_pair

torch.set_num_threads(2)

CLASSES = {
    "FactorVAE": dict(discriminator_units=(8, 8), batchnorm=True),
    "VQVAE": dict(n_codes=8, ema=True, restart_dead=True, dead_frac=0.9,
                  ema_decay=0.5),
    "HypersphericalVAE": {},
}


@pytest.fixture
def rehearsed_graph(monkeypatch):
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


def _seeded(state, seed=5):
  return state.replace(rng=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_graphed_steps_equal_eager(cls, rehearsed_graph):
  _, vae = make_pair(cls, **CLASSES[cls])
  step = vae.make_step_fn()
  start = vae.state
  batches = torch.from_numpy(np.stack([binary_images(2 * B, i)
                                       for i in range(3)]))
  s_e = _seeded(start)
  for i in range(3):
    s_e, m_e = step(s_e, batches[i])
  fused = scan_steps(step, 3)
  s_g, m_g = fused(_seeded(start), batches)
  want, got = _state_leaves(s_e), _state_leaves(s_g)
  assert set(got) == set(want)
  for k in want:
    assert torch.equal(got[k], want[k]), k
  assert set(m_g) == set(m_e)
  for k in m_e:
    assert torch.equal(m_g[k], m_e[k]), k
  held = {k: v.clone() for k, v in got.items()}
  s_g2, _ = fused(s_g, batches)
  assert int(s_g2.step) == 6
  for k, v in held.items():
    assert torch.equal(_state_leaves(s_g)[k], v), k


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_fit_trains_each(cls, rehearsed_graph):
  _, vae = make_pair(cls, **CLASSES[cls])
  data = [binary_images(2 * B, i) for i in range(40)]
  x_valid = torch.from_numpy(binary_images(2 * B, 99))
  eval_fn = vae.make_eval_fn()
  before = float(eval_fn(vae.state, x_valid)["loss"])
  vae.fit(data, max_iter=40, steps_per_call=10, learning_rate=3e-3,
          verbose=False)
  assert vae.step == 40 and int(vae.state.skipped_updates) == 0
  assert float(eval_fn(vae.state, x_valid)["loss"]) < before
