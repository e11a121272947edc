"""The port's ``Trainer.fit`` against the JAX package's on the CPU.

The full-width dSprites beta-VAE at batch 4 (tests/torch_training_common.py
builds both packages' models on the same params): each package's trainer
drives its own step over the same batches, the port's step fed the JAX
package's noise replayed from its keys (the test wraps the step; the JAX
package trains on one CPU device).  At steps_per_call 1 and 3, with
validation every 3 steps, a callback returning a dict, ``BestWeights``
rolling back at every validation (mode 'max' on a falling loss, margin 0),
``EarlyStopping`` that ends the run at its third validation whatever the
values (no improvement counts, progression length 1), and, in another
run, the NaN stop.  Limits: params by the params rule (every element within
2·lr·N, all but 2e-5 within 1e-5); logged metrics rtol 1e-4 (float32 sums
over 4,096 pixels in another order); every record's step, tag and keys
exactly; ``time`` and ``steps_per_sec`` are not compared.
Checkpoints: restored states equal the saved ones bitwise, and a writer's
error surfaces from ``wait_for_checkpoint``.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

import jax

from odin_tpu.parallel import get_mesh
from odin_tpu.training import BestWeights as JaxBestWeights
from odin_tpu.training import EarlyStopping as JaxEarlyStopping
from odin_tpu.training import Trainer as JaxTrainer
from odin_tpu.training import early_stopping_callback as jax_es_callback
from odin_tpu_torch.training import (BestWeights, EarlyStopping, Noise,
                                     Trainer, early_stopping_callback,
                                     read_tensorboard, state_to_host)
from torch_training_common import (ZDIM, assert_params_close, binary_images,
                                   jax_adam, make_pair, np_tree, port_tree,
                                   step_noise)

torch.set_num_threads(2)

B = 4
RTOL = 1e-4
TIMING = ("time", "steps_per_sec")


@pytest.fixture(scope="module")
def pair():
  return make_pair(beta=1.0)


def replay_noise(step, epss):
  """The port's step drawing the given noise at each step count."""

  class Replayed(type(step)):

    def run(self, state, batch, noise):
      return super().run(state, batch,
                         Noise(eps=torch.from_numpy(epss[int(state.step)])))

  out = copy.copy(step)
  out.__class__ = Replayed
  return out


def jax_noise(jvae, n):
  rng, out = jvae.state.rng, []
  for _ in range(n):
    rng, eps = step_noise(rng, B)
    out.append(eps)
  return out


EVAL_EPS = np.array(jax.random.normal(
    jax.random.split(jax.random.PRNGKey(0))[1], (B, ZDIM)))


def assert_records_match(got, want):
  assert [(r["step"], r["tag"], sorted(r)) for r in got] == \
      [(r["step"], r["tag"], sorted(r)) for r in want]
  for g, w in zip(got, want):
    for k, v in w.items():
      if k not in TIMING + ("step", "tag"):
        np.testing.assert_allclose(g[k], v, rtol=RTOL, err_msg=k)


def run_both(pair, tmp_path, k, n_steps, max_iter, nan_at=None, **fit_kw):
  """Both trainers over the same batches: ((JAX trainer, JAX state),
  (port trainer, port state))."""
  jvae, vae = pair
  start = (jvae.state, vae.state)
  policy = "stop" if nan_at is not None else "skip"
  jstep = jvae.make_step_fn(learning_rate=1e-3, nan_policy=policy, jit=False)
  step = vae.make_step_fn(learning_rate=1e-3, nan_policy=policy)
  batches = [binary_images(B, 200 + i) for i in range(n_steps)]
  if nan_at is not None:
    batches[nan_at][0, 0, 0, 0] = np.nan
  valid = [binary_images(B, 300)]
  step = replay_noise(step, jax_noise(jvae, n_steps))

  def eval_fn(state, batch):
    return vae.make_eval_fn()(state, batch, eps=torch.from_numpy(EVAL_EPS))

  def twice(trainer, state, metrics):
    return {"twice_loss": 2 * metrics["loss"]}

  out = []
  for name, trainer_cls, fit_step, state, ev, hooks in (
      ("jax", JaxTrainer, jax.jit(jstep) if k == 1 else jstep,
       jax.device_get(jvae.state), jvae.make_eval_fn(),
       fit_kw.get("jax_hooks", ())),
      ("port", Trainer, step, vae.state, eval_fn,
       fit_kw.get("port_hooks", ()))):
    tr = trainer_cls(logdir=str(tmp_path / name), logging_interval=0.0,
                     use_tensorboard=False)
    extra = dict(mesh=get_mesh(devices=jax.devices()[:1])) \
        if name == "jax" else {}
    s = tr.fit(iter(batches), fit_step, state, valid_ds=valid, eval_fn=ev,
               valid_freq=3, max_iter=max_iter, callbacks=[twice],
               on_valid_end=hooks, steps_per_call=k, verbose=False, **extra)
    out.append((tr, s))
  jvae.state, vae.state = start
  return out


@pytest.mark.parametrize("k", [1, 3])
def test_fit_matches_jax(pair, tmp_path, k):
  """Validation at steps 3, 6, 9; BestWeights rolls back each time;
  EarlyStopping ends the run at step 9 of 12."""

  def hooks(best, es, cb):
    return [best(metric="loss", mode="max", restore_margin=0.0),
            cb(es(min_improvement=1e9, warmup_epochs=1, patience=2,
                  progression_length=1))]

  (jtr, js), (tr, s) = run_both(
      pair, tmp_path, k, n_steps=12, max_iter=12,
      jax_hooks=hooks(JaxBestWeights, JaxEarlyStopping, jax_es_callback),
      port_hooks=hooks(BestWeights, EarlyStopping, early_stopping_callback))
  assert int(s.step) == int(js.step) == 9
  assert tr.step == jtr.step == 9
  assert [r["step"] for r in tr.valid_history] == [3, 6, 9]
  assert_records_match(tr.history, jtr.history)
  assert_records_match(tr.valid_history, jtr.valid_history)
  assert "twice_loss" in tr.history[-1]
  assert_params_close(np_tree(s.params)["vae"], port_tree(js.params)["vae"],
                      9)
  # the validation at step 9 rolled back to the step-3 state (step and
  # generator kept)
  assert int(s.opt_states["vae"]["count"]) == \
      int(jax_adam(js.opt_states["vae"]).count) == 3
  logged = [json.loads(line) for line in
            open(os.path.join(tr.logdir, "log.jsonl"))]
  assert logged == tr.read_logs()
  key = lambda r: (r["step"], r["tag"])
  assert sorted(map(key, logged)) == \
      sorted(map(key, tr.history + tr.valid_history))
  assert_records_match(sorted(logged, key=key), sorted(
      [json.loads(line) for line in
       open(os.path.join(jtr.logdir, "log.jsonl"))], key=key))
  curves = read_tensorboard(tr.logdir)
  assert [st for st, _ in curves["loss"]] == [r["step"] for r in logged]


@pytest.mark.parametrize("k", [1, 3])
def test_nan_stop_matches_jax(pair, tmp_path, k):
  """A NaN in the batch of step 6: both stop after it, the update
  skipped."""
  (jtr, js), (tr, s) = run_both(pair, tmp_path, k, n_steps=9, max_iter=9,
                                nan_at=5)
  assert int(s.step) == int(js.step) == 6
  assert int(s.skipped_updates) == int(js.skipped_updates) == 1
  assert tr.history[-1]["nan_gradients"] == 1.0
  assert_records_match(tr.history, jtr.history)
  assert_params_close(np_tree(s.params)["vae"], port_tree(js.params)["vae"],
                      5)


def _assert_states_equal(a, b):
  """Every tensor of two states equal (their generators are compared
  where it matters: states share a live generator)."""
  ha, hb = state_to_host(a), state_to_host(b)
  flat = lambda h: {k: v for k, v in _named(h) if k != "/rng_state"}
  fa, fb = flat(ha), flat(hb)
  assert set(fa) == set(fb)
  for k in fa:
    assert torch.equal(fa[k], fb[k]), k


def _named(tree, prefix=""):
  if isinstance(tree, dict):
    for k, v in tree.items():
      yield from _named(v, f"{prefix}/{k}")
  elif isinstance(tree, torch.Tensor):
    yield prefix, tree


def test_checkpoints_round_trip(pair, tmp_path):
  _, vae = pair
  start = vae.state
  step = vae.make_step_fn(learning_rate=1e-3)
  s, _ = step(vae.state, binary_images(B, 1))
  tr = Trainer(logdir=str(tmp_path), use_tensorboard=False)
  path = tr.save_checkpoint(s)
  back = tr.restore_checkpoint()
  _assert_states_equal(back, s)
  assert torch.equal(back.rng.get_state(), s.rng.get_state())
  # non-blocking: the snapshot is taken at the call, whatever runs next
  snap_host = state_to_host(s)
  tr.save_checkpoint(s, str(tmp_path / "async"), blocking=False)
  s2, _ = step(s, binary_images(B, 2))
  tr.wait_for_checkpoint()
  got = tr.restore_checkpoint(str(tmp_path / "async"))
  _assert_states_equal(got, s)
  assert torch.equal(got.rng.get_state(), snap_host["rng_state"])
  assert not torch.equal(s2.rng.get_state(), snap_host["rng_state"])
  assert os.path.exists(path) and not os.path.exists(path + ".tmp")
  # a writer's failure surfaces from wait_for_checkpoint
  tr.save_checkpoint(s, str(tmp_path / "missing" / "ckpt"), blocking=False)
  with pytest.raises(RuntimeError, match="async checkpoint write failed"):
    tr.wait_for_checkpoint()
  tr.wait_for_checkpoint()  # raised once
  assert Trainer(logdir=str(tmp_path / "none")).restore_checkpoint() is None
  with pytest.raises(NotImplementedError, match="not ported yet"):
    tr.save_checkpoint_orbax(s)
  vae.state = start


def test_fit_checkpoints_the_state_at_its_step(pair, tmp_path):
  """checkpoint_freq 2 over 4 steps at steps_per_call 2: the checkpoint
  written after step 4 (non-blocking, joined by fit) is the final state."""
  _, vae = pair
  start = vae.state
  step = vae.make_step_fn(learning_rate=1e-3)
  batches = [binary_images(B, 500 + i) for i in range(6)]
  tr = Trainer(logdir=str(tmp_path), use_tensorboard=False)
  s = tr.fit(iter(batches), step, vae.state, max_iter=4, checkpoint_freq=2,
             steps_per_call=2, verbose=False)
  assert int(s.step) == 4
  _assert_states_equal(tr.restore_checkpoint(), s)
  with pytest.raises(NotImplementedError, match="mesh"):
    tr.fit(iter(batches), step, s, mesh=object())
  vae.state = start


def test_trace_and_curves(pair, tmp_path):
  """``trace`` writes a ``torch.profiler`` trace of the armed steps, and
  ``plot_learning_curves`` draws the logged metrics."""
  _, vae = pair
  start = vae.state
  step = vae.make_step_fn(learning_rate=1e-3)
  batches = [binary_images(B, 600 + i) for i in range(3)]
  tr = Trainer(logdir=str(tmp_path), logging_interval=0.0,
               use_tensorboard=False).trace(2)
  tr.fit(iter(batches), step, vae.state, max_iter=3, verbose=False)
  traces = os.listdir(tmp_path / "profile")
  assert traces == ["trace_step2.json"]
  with open(tmp_path / "profile" / traces[0]) as f:
    assert json.load(f)["traceEvents"]
  png = tr.plot_learning_curves()
  assert os.path.getsize(png) > 0
  vae.state = start
