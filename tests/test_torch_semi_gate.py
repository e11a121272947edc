"""The Semafo family's step-gated terms inside a captured step: the MI
term's gradient gate (``steps_without_mi``) and its ``mi_coef`` schedule
read the step as a tensor, never on the host, so k steps of one CUDA graph
cross the gate as eager steps do, a batch with no labelled row among
them.

On the CPU the graphed path is rehearsed (the ``_StepGraph`` stand-in of
tests/test_torch_training.py, whose replay runs the captured body again),
and the step is carried as a tensor that raises when the host reads it (a
CUDA graph capture fails on such a read); tests/test_torch_cuda.py holds a
real graph against eager steps on the card."""
import types

import numpy as np
import pytest
import torch

import odin_tpu_torch.bay.vi as vi
from odin_tpu_torch.training import core as training_core
from odin_tpu_torch.training import scan_steps
from torch_semi_common import semi_batch, semi_networks

GATE = 2
STEPS = 4  # steps 0-3 straddle the gate at 2


class HostRead(torch.Tensor):
  """A step counter that raises where the host would read it."""

  def _read(self, *args, **kwargs):
    raise RuntimeError("the step was read on the host")

  __bool__ = __int__ = __float__ = __index__ = item = tolist = _read


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


def _model(name):
  return getattr(vi, name)(steps_without_mi=GATE,
                           **semi_networks(name, "torch")).build(
                               device="cpu")


def _batches(name):
  """STEPS (x, y, mask) batches; the second has no labelled row."""
  b = [semi_batch(name, 30 + i, n_labelled=0 if i == 1 else 4)
       for i in range(STEPS)]
  return tuple(torch.from_numpy(np.stack([x[j] for x in b]))
               for j in range(3))


@pytest.mark.parametrize("name", ["SemafoVAE", "semafod", "semafos",
                                  "semafop"])
def test_graphed_steps_straddling_the_gate_equal_eager(name,
                                                       rehearsed_graph):
  vae = _model(name)
  step = vae.make_step_fn()
  batches = _batches(name)
  start = vae.state
  rng = start.rng.get_state()
  s = start
  for i in range(STEPS):
    s, m = step(s, tuple(t[i] for t in batches))
  start.rng.set_state(rng)
  g, mg = scan_steps(step, STEPS)(start, batches)
  assert int(g.step) == int(s.step) == STEPS
  assert int(g.skipped_updates) == int(s.skipped_updates) == 0
  for k, v in s.params["vae"].items():
    assert torch.equal(g.params["vae"][k], v), k
  assert sorted(mg) == sorted(m)
  for k in m:
    assert float(mg[k]) == float(m[k]), k


@pytest.mark.parametrize("name", ["SemafoVAE", "RemafoVAE", "semafod",
                                  "semafoh", "semafos", "semafosm",
                                  "semafosc", "semafop", "semafot"])
def test_the_step_is_never_read_on_the_host(name):
  vae = _model(name)
  step = vae.make_step_fn()
  held = vae.state.replace(step=vae.state.step.as_subclass(HostRead))
  with pytest.raises(RuntimeError, match="read on the host"):
    bool(held.step >= GATE)  # the guard itself
  x, y, mask = (torch.from_numpy(a) for a in semi_batch(name, 5))
  s, m = step(held, (x, y, mask))  # the step's arithmetic stays on tensors
  assert all(np.isfinite(float(v.as_subclass(torch.Tensor)))
             for v in m.values())


def test_the_gate_stops_the_mi_gradient_until_its_step():
  """Before the gate the MI term moves no param (the step equals one with
  the term's coefficient at 0); from the gate on it does."""
  name = "SemafoVAE"
  x, y, mask = (torch.from_numpy(a) for a in semi_batch(name, 5))
  out = {}
  for coef in (None, 0.0):
    for at in (GATE - 1, GATE):
      vae = _model(name) if coef is None else getattr(vi, name)(
          steps_without_mi=GATE, mi_coef=coef,
          **semi_networks(name, "torch")).build(device="cpu")
      step = vae.make_step_fn()
      state = vae.state.replace(step=torch.tensor(at, dtype=torch.int32))
      s, _ = step(state, (x, y, mask))
      out[coef, at] = s.params["vae"]
  before = [torch.equal(out[None, GATE - 1][k], out[0.0, GATE - 1][k])
            for k in out[None, GATE - 1]]
  after = [torch.equal(out[None, GATE][k], out[0.0, GATE][k])
           for k in out[None, GATE]]
  assert all(before) and not all(after)
