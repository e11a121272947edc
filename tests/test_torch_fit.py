"""``VariationalAutoencoder.fit``, ``fit_device_dataset``, persistence and
the estimators of the port on the CPU, with the JAX package where it is the
reference.

  * ``vae.fit`` is ``Trainer.fit`` over ``make_step_fn``: equal bitwise on
    the same batches and generator.
  * Resuming ``fit_device_dataset``: 2k steps in one run equal k steps,
    ``save_weights``, ``load_weights`` and k more with
    ``keep_opt_states=True`` (bitwise in the port, whose draws and noise
    are keyed by the seed, the step count and the saved generator; to
    float32 rounding in the JAX package, whose calls are compiled
    separately).  A new ``device_dataset_steps`` object continues the
    stream instead of repeating it.
  * ``marginal_log_prob`` and ``sample_traverse`` against the JAX package
    on the same params and noise: rtol 1e-4 on log-likelihoods (sums over
    4,096 pixels), atol 1e-4 on logits (as tests/test_torch_betavae.py).
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from odin_tpu.bay.vi import BetaVAE as JaxBetaVAE
from odin_tpu.networks import get_networks as jax_get_networks
from odin_tpu_torch.bay.vi import BetaVAE
from odin_tpu_torch.fuel import DataPipeline
from odin_tpu_torch.networks import get_networks
from odin_tpu_torch.training import (Trainer, device_dataset_steps,
                                     step_indices)
from torch_training_common import ZDIM, binary_images, make_pair

torch.set_num_threads(2)

B = 4
RTOL = 1e-4
ATOL = 1e-4


def _model(seed=1):
  return BetaVAE(beta=4.0, **get_networks("dsprites", zdim=ZDIM)).build(
      seed=seed, device="cpu")


def _equal(a, b):
  for k, v in a.params["vae"].items():
    assert torch.equal(b.params["vae"][k], v), k
  for n in ("mu", "nu"):
    for k, v in a.opt_states["vae"][n]["vae"].items():
      assert torch.equal(b.opt_states["vae"][n]["vae"][k], v), k
  assert int(a.step) == int(b.step)
  assert int(a.opt_states["vae"]["count"]) == int(b.opt_states["vae"]["count"])


@pytest.mark.parametrize("k", [1, 2])
def test_vae_fit_is_trainer_fit(k):
  images = binary_images(12, 9)
  pipe = lambda: DataPipeline(images, batch_size=B, shuffle=True, epochs=-1,
                              seed=3)
  a, b = _model(), _model()
  tr = a.fit(pipe(), max_iter=4, steps_per_call=k, logging_interval=0.0,
             verbose=False)
  step = b.make_step_fn(learning_rate=1e-3)
  state = Trainer(logging_interval=0.0).fit(pipe(), step, b.state,
                                            max_iter=4, steps_per_call=k,
                                            verbose=False)
  _equal(a.state, state)
  assert a.step == 4 and tr.step == 4 and a.trainer is tr
  assert "step=4" in repr(a)


@pytest.fixture(scope="module")
def corpus():
  return (binary_images(32, 11) * 255).astype(np.uint8)


def test_fit_device_dataset_resumes_exactly(corpus, tmp_path):
  """Unbroken: 4 steps in calls of 2.  Split: 2 steps with a checkpoint,
  then a new model loads it and runs 2 more with keep_opt_states."""
  whole = _model().fit_device_dataset(corpus, n_steps=4, batch_size=B,
                                      steps_per_call=2, seed=5,
                                      verbose=False)
  ckpt = str(tmp_path / "ckpt")
  first = _model().fit_device_dataset(corpus, n_steps=2, batch_size=B,
                                      steps_per_call=2, seed=5,
                                      verbose=False, checkpoint_path=ckpt,
                                      checkpoint_freq=2)
  resumed = _model(seed=9).load_weights(ckpt)
  _equal(resumed.state, first.state)
  resumed.fit_device_dataset(corpus, n_steps=2, batch_size=B,
                             steps_per_call=2, seed=5, verbose=False,
                             keep_opt_states=True)
  _equal(resumed.state, whole.state)
  # and through save_weights / load_weights of a model trained 2 steps
  path = str(tmp_path / "weights")
  first.save_weights(path)
  again = _model(seed=3).load_weights(path)
  assert again.md5_checksum() == first.md5_checksum()
  assert again.step == 2
  again.fit_device_dataset(corpus, n_steps=2, batch_size=B, steps_per_call=1,
                           seed=5, verbose=False, keep_opt_states=True)
  _equal(again.state, whole.state)
  assert again.md5_checksum() != first.md5_checksum()


class _Recording:
  """A training step that records the batches it is given."""

  def __new__(cls, step, seen):

    class Recorded(type(step)):

      def run(self, state, batch, noise):
        seen.append(batch.clone())
        return super().run(state, batch, noise)

    out = copy.copy(step)
    out.__class__ = Recorded
    return out


def test_a_new_object_continues_the_stream(corpus):
  """Draws are keyed by the step count: a new ``device_dataset_steps``
  object started at step 2 draws what an unbroken run draws at steps 2-3,
  not what the first object drew at steps 0-1."""
  vae = _model()
  step = vae.make_step_fn(learning_rate=1e-3)
  seen_whole, seen_split = [], []
  device_dataset_steps(_Recording(step, seen_whole), B, 4, seed=5)(
      vae.state, corpus)
  rec = _Recording(step, seen_split)
  s, _ = device_dataset_steps(rec, B, 2, seed=5)(vae.state, corpus)
  device_dataset_steps(rec, B, 2, seed=5)(s, corpus)
  for a, b in zip(seen_split, seen_whole):
    assert torch.equal(a, b)
  assert not torch.equal(seen_split[2], seen_split[0])
  for i in range(4):
    want = corpus[step_indices(5, i, B, len(corpus)).numpy()] / 255.0
    np.testing.assert_array_equal(seen_whole[i].numpy(),
                                  want.astype(np.float32))


def test_step_indices_are_uniform_and_keyed():
  a = step_indices(0, 3, 4096, 10)
  assert torch.equal(a, step_indices(0, torch.tensor(3, dtype=torch.int32),
                                     4096, 10))
  assert not torch.equal(a, step_indices(0, 4, 4096, 10))
  assert not torch.equal(a, step_indices(1, 3, 4096, 10))
  counts = torch.bincount(a, minlength=10).numpy()
  assert counts.min() > 330 and counts.max() < 490  # 409.6 expected


def _jax_model():
  return JaxBetaVAE(beta=1.0, **jax_get_networks("halfmoons", zdim=2)).build(
      seed=0)


def test_jax_fit_device_dataset_resumes(tmp_path):
  """The JAX package's contract, on its small halfmoons model."""
  X = np.random.RandomState(0).rand(128, 2).astype("float32")
  kw = dict(batch_size=16, steps_per_call=3, seed=2, verbose=False)
  whole = _jax_model().fit_device_dataset(X, n_steps=6, **kw)
  first = _jax_model().fit_device_dataset(X, n_steps=3, **kw)
  path = str(tmp_path / "jax_weights")
  first.save_weights(path)
  resumed = _jax_model().load_weights(path)
  resumed.fit_device_dataset(X, n_steps=3, keep_opt_states=True, **kw)
  assert int(resumed.state.step) == int(whole.state.step) == 6
  got = jax.tree_util.tree_leaves(jax.device_get(resumed.state.params))
  want = jax.tree_util.tree_leaves(jax.device_get(whole.state.params))
  for g, w in zip(got, want):
    np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6,
                               atol=1e-7)


@pytest.fixture(scope="module")
def pair():
  return make_pair(beta=1.0)


@pytest.mark.parametrize("batch_size", [None, 3])
def test_marginal_log_prob_matches_jax(pair, batch_size):
  jvae, vae = pair
  x = binary_images(5, 21)
  S = 6
  key = jax.random.PRNGKey(0)
  if batch_size is None:
    eps = jax.random.normal(key, (S, 5, ZDIM))
  else:
    eps = jnp.concatenate([
        jax.random.normal(jax.random.fold_in(key, i),
                          (S, min(batch_size, 5 - i), ZDIM))
        for i in range(0, 5, batch_size)], axis=1)
  want = jvae.marginal_log_prob(x, n_samples=S, seed=0,
                                batch_size=batch_size)
  got = vae.marginal_log_prob(x, n_samples=S, batch_size=batch_size,
                              eps=torch.from_numpy(np.array(eps)))
  for g, w in zip(got, want):
    assert tuple(g.shape) == (5,)
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
  # from its own generator: finite, and the same for the same seed
  a = vae.marginal_log_prob(x, n_samples=S, seed=3)[0]
  assert torch.isfinite(a).all()
  assert torch.equal(a, vae.marginal_log_prob(x, n_samples=S, seed=3)[0])


@pytest.mark.parametrize("mode", ["linear", "quantile"])
def test_sample_traverse_matches_jax(pair, mode):
  jvae, vae = pair
  x = binary_images(2, 22)
  kw = dict(feature_indices=[0, 3], n_traverse_points=3, mode=mode)
  want = jvae.sample_traverse(x, **kw)
  got = vae.sample_traverse(x, **kw)
  assert tuple(got.mean().shape) == (12, 64, 64, 1)
  np.testing.assert_allclose(got.distribution.logits.numpy(),
                             np.asarray(want.distribution.logits), atol=ATOL)
