"""Multi-seed training of the port (``multiseed_device_dataset_steps``,
``stack_states``, ``unstack_states``) on the CPU, on the 8x8 beta-VAE of
tests/torch_zoo_common.py.

The contract, the port's version of tests/test_multiseed.py's:

  * lane i draws its batches with ``step_indices(seeds[i], step)`` and its
    noise from its own state's generator, so after 5 steps its params are
    those of ``device_dataset_steps(seed=seeds[i])`` from the same state
    within atol 1e-5; lanes from different inits differ;
  * the lanes run as one ``vmap``ped step (the loss function is called once
    a step, not once a lane);
  * a NaN in one lane's noise skips that lane's update alone;
  * the corpus is shared; every metric gains a leading (S,) axis;
  * against the JAX package's ``multiseed_device_dataset_steps`` on the
    same params, with its batch indices and noise replayed from its keys:
    losses rtol 1e-4, params by ``assert_params_close``
    (tests/torch_training_common.py) with at least one element allowed
    beyond 1e-5.  Its share of 2e-5 allows none of this model's 6,289
    params; one kernel element of lane 0 (seed 3) has a gradient of about
    2e-9 at the first step, where Adam's update g / (|g| + 1e-8) carries
    the packages' rounding into the param: 2.76e-5 apart, from the first
    step on (every element stays within 2·lr·N).

The generators are objects: a step advances its state's generator, and a
stacked state holds its lanes' generators, so each test saves and restores
their states before it runs a lane alone.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from odin_tpu.training.core import (
    multiseed_device_dataset_steps as jax_multiseed,
    stack_states as jax_stack)
from odin_tpu_torch.training import (core as training_core,
                                     device_dataset_steps,
                                     multiseed_device_dataset_steps,
                                     stack_states, unstack_states)
from torch_training_common import FAR_SHARE, assert_params_close
from torch_zoo_common import jax_state_of, make_pair, np_tree, port_tree

torch.set_num_threads(2)

SEEDS = [3, 7]
B, N_STEPS, ZDIM = 8, 5, 4
LANE_ATOL = 1e-5


def _corpus():
  return (np.random.RandomState(0).rand(64, 8, 8, 1) > 0.5).astype(
      np.uint8) * np.uint8(255)


@pytest.fixture(scope="module")
def lanes():
  """(the port's step, each seed's state with Adam's moments started, the
  JAX models of the same params)."""
  pairs = [make_pair("BetaVAE", seed=s, beta=2.0) for s in SEEDS]
  step = None
  for _, vae in pairs:
    step = vae.make_step_fn(learning_rate=1e-3)
  return step, [vae.state for _, vae in pairs], pairs


def _rng_states(states):
  return [s.rng.get_state() for s in states]


def _restore(states, saved):
  for s, g in zip(states, saved):
    s.rng.set_state(g)


def _max_apart(a, b):
  return max(float((a[k] - v).abs().max()) for k, v in b.items())


def test_lanes_match_solo_runs(lanes):
  step, states, _ = lanes
  saved = _rng_states(states)
  data = torch.from_numpy(_corpus())
  fused = multiseed_device_dataset_steps(step, B, N_STEPS, seeds=SEEDS)
  stacked, m = fused(stack_states(states), data)
  out = unstack_states(stacked)
  for i, seed in enumerate(SEEDS):
    _restore(states, saved)
    solo, m_solo = device_dataset_steps(step, B, N_STEPS, seed=seed)(
        states[i], data)
    assert _max_apart(out[i].params["vae"], solo.params["vae"]) <= LANE_ATOL
    assert float(m["loss"][i]) == pytest.approx(float(m_solo["loss"]),
                                                rel=1e-6)
    assert int(out[i].step) == int(solo.step) == N_STEPS
    assert int(out[i].opt_states["vae"]["count"]) == N_STEPS
  _restore(states, saved)
  assert _max_apart(out[0].params["vae"], out[1].params["vae"]) > 1e-3
  for k, v in m.items():
    assert tuple(v.shape) == (len(SEEDS),), k
    assert bool(torch.isfinite(v).all())
  assert torch.equal(stacked.step, torch.full((2,), N_STEPS,
                                              dtype=torch.int32))


def test_lanes_run_as_one_vmapped_step(lanes, monkeypatch):
  """The loss is called once a step for all lanes (and once by the probe
  that records the draws), not once a lane."""
  step, states, _ = lanes
  saved = _rng_states(states)
  ts = step.train_steps[0]
  calls = []

  def counted(*args):
    calls.append(1)
    return loss_fn(*args)

  loss_fn = ts.loss_fn
  monkeypatch.setattr(ts, "loss_fn", counted)
  three = stack_states([states[0], states[1], states[0]])
  fused = multiseed_device_dataset_steps(step, B, 3, seeds=[1, 2, 3])
  fused(three, torch.from_numpy(_corpus()))
  assert len(calls) == 1 + 3
  _restore(states, saved)


def test_nan_in_one_lane_skips_that_lane(lanes):
  step, states, _ = lanes
  data = torch.from_numpy(_corpus())
  eps = torch.from_numpy(np.random.RandomState(2).randn(
      3, 2, B, ZDIM).astype(np.float32))
  bad = eps.clone()
  bad[1, 0, 2, 1] = float("nan")
  fused = multiseed_device_dataset_steps(step, B, 3, seeds=SEEDS)
  good, _ = fused(stack_states(states), data, eps=eps)
  skip, m = fused(stack_states(states), data, eps=bad)
  assert skip.skipped_updates.tolist() == [1, 0]
  assert skip.step.tolist() == [3, 3]
  assert int(skip.opt_states["vae"]["count"][0]) == 2
  assert int(skip.opt_states["vae"]["count"][1]) == 3
  for k, v in good.params["vae"].items():
    assert torch.equal(skip.params["vae"][k][1], v[1]), k
  assert _max_apart({k: v[0] for k, v in skip.params["vae"].items()},
                    {k: v[0] for k, v in good.params["vae"].items()}) > 0
  assert bool(torch.isfinite(m["loss"]).all())


def test_stack_and_unstack(lanes):
  _, states, _ = lanes
  stacked = stack_states(states)
  assert stacked.rng == tuple(s.rng for s in states)
  back = unstack_states(stacked)
  for s, b in zip(states, back):
    assert b.rng is s.rng
    for k, v in s.params["vae"].items():
      assert torch.equal(b.params["vae"][k], v)
    for k, v in s.opt_states["vae"]["mu"]["vae"].items():
      assert torch.equal(b.opt_states["vae"]["mu"]["vae"][k], v)
  # copies: changing a lane leaves the stacked state as it was
  k = next(iter(back[0].params["vae"]))
  back[0].params["vae"][k].add_(1.0)
  assert torch.equal(stacked.params["vae"][k][0], states[0].params["vae"][k])


def test_sample_fn_lanes_match_solo_runs(lanes):
  """A lane's `sample_fn` generator is seeded as its solo run's is."""
  step, states, _ = lanes
  saved = _rng_states(states)
  data = torch.from_numpy(_corpus())

  def sample_fn(gen, d):
    idx = torch.randint(0, d.shape[0], (B,), generator=gen)
    return d.index_select(0, idx).float() / 255.0

  fused = multiseed_device_dataset_steps(step, B, 3, seeds=SEEDS,
                                         sample_fn=sample_fn)
  out = unstack_states(fused(stack_states(states), data)[0])
  for i, seed in enumerate(SEEDS):
    _restore(states, saved)
    solo, _ = device_dataset_steps(step, B, 3, seed=seed,
                                   sample_fn=sample_fn)(states[i], data)
    assert _max_apart(out[i].params["vae"], solo.params["vae"]) <= LANE_ATOL
  _restore(states, saved)


def test_graphed_lanes_equal_eager(lanes, monkeypatch):
  """The graphed path's buffers, rehearsed on the CPU (the replay runs the
  captured step again): two calls equal one eager call of twice the
  steps, and a state a call returned keeps its values."""
  step, states, _ = lanes
  saved = _rng_states(states)
  data = torch.from_numpy(_corpus())
  eager, _ = multiseed_device_dataset_steps(step, B, 4, seeds=SEEDS)(
      stack_states(states), data)
  _restore(states, saved)

  def capture(self, state, inputs, body, generators):
    self.state = training_core._clone_state(state)
    self.inputs = {k: v.clone() for k, v in inputs.items()}
    self.slot = torch.zeros(1, dtype=torch.int64)

    def replay():
      self._metrics = self._one_step(body)

    self._graph = type("G", (), {"replay": staticmethod(replay)})
    self._metrics = {}
    self.capture_seconds = 0.0

  monkeypatch.setattr(training_core._StepGraph, "_capture", capture)
  monkeypatch.setattr(training_core, "_use_graph", lambda graph, state: True)
  fused = multiseed_device_dataset_steps(step, B, 2, seeds=SEEDS)
  s1, _ = fused(stack_states(states), data)
  held = s1.params["vae"]["encoder.layers.0.weight"].clone()
  s2, m2 = fused(s1, data)
  assert torch.equal(s1.params["vae"]["encoder.layers.0.weight"], held)
  for k, v in eager.params["vae"].items():
    assert torch.equal(s2.params["vae"][k], v), k
  assert s2.step.tolist() == [4, 4] and tuple(m2["loss"].shape) == (2,)
  _restore(states, saved)


def test_options_the_lanes_cannot_take(lanes):
  step, states, pairs = lanes
  vae = pairs[0][1]
  for kwargs in (dict(remat=True), dict(accum_steps=2)):
    with pytest.raises(ValueError, match="accum_steps and remat"):
      multiseed_device_dataset_steps(
          vae.make_step_fn(learning_rate=1e-3, **kwargs), B, 2, seeds=SEEDS)
  vae.state = states[0]
  fused = multiseed_device_dataset_steps(step, B, 2, seeds=[1, 2, 3])
  with pytest.raises(ValueError, match="3 lanes"):
    fused(stack_states(states), torch.from_numpy(_corpus()))


def _jax_draws(states, seeds, n):
  """Each lane's batch indices and noise of JAX's multi-seed run: the
  indices ``randint(fold_in(PRNGKey(seed), step), (B,), 0, n)``, the noise
  ``normal(split(step_rng)[1], (B, zdim))`` of the step's split of the
  state's key (tests/torch_training_common.py's ``step_noise``)."""
  idx = np.zeros((N_STEPS, len(seeds), B), np.int64)
  eps = np.zeros((N_STEPS, len(seeds), B, ZDIM), np.float32)
  for i, (state, seed) in enumerate(zip(states, seeds)):
    rng = state.rng
    for t in range(N_STEPS):
      key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
      idx[t, i] = np.asarray(jax.random.randint(key, (B,), 0, n))
      rng, step_rng = jax.random.split(rng)
      eps[t, i] = np.asarray(jax.random.normal(
          jax.random.split(step_rng)[1], (B, ZDIM)))
  return idx, eps


def test_lanes_match_jax(lanes):
  step, states, pairs = lanes
  jsteps = []
  for (jvae, vae), state in zip(pairs, states):
    vae.state = state
    jvae.state = jax_state_of(vae, seed=SEEDS[len(jsteps)])
    jsteps.append(jvae.make_step_fn(learning_rate=1e-3, jit=False))
  jstates = [jvae.state for jvae, _ in pairs]
  X = _corpus()
  fused = jax.jit(jax_multiseed(jsteps[0], B, N_STEPS, seeds=SEEDS))
  jstacked, jm = fused(jax_stack(jstates), jnp.asarray(X))
  jstacked = jax.device_get(jstacked)
  idx, eps = _jax_draws(jstates, SEEDS, len(X))
  ours = multiseed_device_dataset_steps(step, B, N_STEPS, seeds=SEEDS)
  stacked, m = ours(stack_states(states), torch.from_numpy(X),
                    indices=torch.from_numpy(idx), eps=torch.from_numpy(eps))
  np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                             rtol=1e-4)
  for i, lane in enumerate(unstack_states(stacked)):
    want = port_tree(jax.tree_util.tree_map(lambda a: a[i],
                                            jstacked.params))["vae"]
    got = np_tree(lane.params)["vae"]
    n_params = sum(v.size for v in got.values())
    assert_params_close(got, want, N_STEPS,
                        share=max(FAR_SHARE, 1.0 / n_params))
  assert stacked.step.tolist() == np.asarray(jstacked.step).tolist()
