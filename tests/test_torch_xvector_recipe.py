"""The x-vector recipe of ``chip_smoke.py`` phase 21
(``chip_smoke.xvector_recipe``: ``examples/voxceleb/recipe.py:76-126``
through the port's API) against the JAX package's lines of the same
recipe, on the CPU at a small scale: 10 speakers x 3 utterances of 1 s
(int16, the port's synthetic speaker corpus), 3 AdamW steps at batch 8,
``embedding_dim`` 8.

* Features: ``batch_speech_features(..., FeatureConfig(n_mels=24,
  n_ceps=14), features=("mfcc_cmvn",))`` of both packages within rtol and
  atol 5e-3 (tests/test_preprocessing.py:382).
* Batches: the indices ``RandomState(1)`` draws, and the trials of
  ``make_trials``, equal to the recipe's own.
* Weights: JAX's ``optax.adamw`` steps from the port's initial weights on
  the port's stacked features.  After one step every element within 2·lr
  of JAX's and all but a 2e-5 share within 1e-5 (the rule of
  ``tests/test_torch_time_delay.py``).  Over 3 steps the losses within
  1e-5 of their magnitude and every element within 2·lr·3; beyond that
  the two float32 runs part where Adam's update of an element is about
  lr·sign(g) and g is rounding-sized (on some corpora JAX's run moves 1 %
  of the elements more than 1e-5 from a float64 run of the same steps,
  the port's almost none), so the port is held to be as close to float64
  as JAX is: its share of elements more than 1e-5 from the float64 run
  at most twice JAX's share (or 2e-5).
* Embeddings: JAX's ``XVectorNet(return_embedding=True)`` on the port's
  trained weights within 1e-5 of their largest magnitude.
* PLDA: JAX's ``PLDA(n_phi=4, n_iter=8)`` fitted on the port's embeddings
  of the first five speakers scores the trials of the other five to
  the port's scores (within 1e-9 of their largest) and the same EER.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chip_smoke
from odin_tpu.backend import compute_EER, det_curve
from odin_tpu.ml import PLDA as JaxPLDA
from odin_tpu.networks.time_delay import XVectorNet as JaxXVectorNet
from odin_tpu.ops.features import FeatureConfig as JaxFeatureConfig
from odin_tpu.preprocessing import batch_speech_features as jax_features
from odin_tpu_torch.fuel.audio_data import synth_speaker_corpus
from odin_tpu_torch.weights import from_jax_params, to_jax_params

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPEAKERS, UTTERANCES, STEPS, BATCH, EMBED = 10, 3, 3, 8, 8
CMVN_TOL = 5e-3
LR = chip_smoke.XV_LR


@pytest.fixture(scope="module")
def recipe():
  torch.set_num_threads(2)
  utts, labels = synth_speaker_corpus(SPEAKERS, UTTERANCES, seed=0,
                                      sr=16000, dur=1.0)
  raw = [np.round(np.clip(u, -1, 1) * 32767).astype(np.int16) for u in utts]
  spk = np.asarray(labels)
  r = chip_smoke.xvector_recipe(torch, np, raw, spk, "cpu", steps=STEPS,
                                batch_size=BATCH, embedding_dim=EMBED)
  return raw, spk, r


def _share(a, b, keys):
  """The share of elements more than 1e-5 apart."""
  return float(np.mean(np.concatenate([
      np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))
      .ravel() for k in keys]) > 1e-5))


def _voxceleb_recipe():
  """``examples/voxceleb/recipe.py`` as a module (for its make_trials)."""
  spec = importlib.util.spec_from_file_location(
      "voxceleb_recipe", ROOT / "examples" / "voxceleb" / "recipe.py")
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def test_features_batches_and_trials_match_jax(recipe):
  raw, spk, r = recipe
  want = [f["mfcc_cmvn"] for f in jax_features(
      raw, JaxFeatureConfig(**chip_smoke.XV_FEATURES),
      features=("mfcc_cmvn",))]
  assert len(r["feats"]) == len(want)
  for got, w in zip(r["feats"], want):
    assert got.shape == w.shape == (r["frames"], 14)
    np.testing.assert_allclose(got, w, rtol=CMVN_TOL, atol=CMVN_TOL)
  rs = np.random.RandomState(1)
  for idx in r["batches"]:
    np.testing.assert_array_equal(idx, rs.randint(0, len(raw), BATCH))
  held = spk >= SPEAKERS // 2
  jpairs, jtruth = _voxceleb_recipe().make_trials(spk[held].astype(int))
  np.testing.assert_array_equal(r["pairs"], jpairs)
  np.testing.assert_array_equal(r["truth"], jtruth)


def _steps_in_float64(r):
  """The recipe's steps from the same weights on the same batches, in
  float64 (the port's AdamW)."""
  import copy
  from odin_tpu_torch.training.core import AdamW
  net = copy.deepcopy(r["net"]).double()
  p = {k: v.double() for k, v in r["init"].items()}
  opt = AdamW(LR, weight_decay=chip_smoke.XV_WD)
  state = opt.init({"net": p})
  X = r["X"].double()
  for idx in r["batches"]:
    q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    loss = chip_smoke.xvector_loss(torch, net, q, X[idx], r["y"][idx])
    g = dict(zip(q, torch.autograd.grad(loss, list(q.values()))))
    with torch.no_grad():
      u, state = opt.update({"net": g}, state, {"net": p})
      p = {k: p[k] + u["net"][k] for k in p}
  return {k: v.numpy() for k, v in p.items()}


def test_training_embeddings_and_plda_match_jax(recipe):
  raw, spk, r = recipe
  net = JaxXVectorNet(n_classes=SPEAKERS, embedding_dim=EMBED)
  X = jnp.asarray(r["X"].numpy())
  labels = jnp.asarray(spk)
  params = to_jax_params(r["net"], r["init"])
  opt = optax.adamw(LR, weight_decay=chip_smoke.XV_WD)

  def loss_fn(p, x, y):
    logits = net.apply({"params": p}, x, training=True)
    return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(len(y)), y])

  @jax.jit
  def step_fn(p, s, x, y):
    loss, grads = jax.value_and_grad(loss_fn)(p, x, y)
    updates, s = opt.update(grads, s, p)
    return optax.apply_updates(p, updates), s, loss

  state = opt.init(params)
  losses = []
  for i, idx in enumerate(r["batches"]):
    params, state, loss = step_fn(params, state, X[idx], labels[idx])
    losses.append(float(loss))
    if i == 0:  # one step: the port's own one-step run of the recipe
      one = chip_smoke.xvector_recipe(torch, np, raw, spk, "cpu", steps=1,
                                      batch_size=BATCH, embedding_dim=EMBED)
      got1 = {k: v.numpy() for k, v in one["params"].items()}
      want1 = {k: v.numpy() for k, v in
               from_jax_params(jax.device_get(params)).items()}
      assert max(float(np.abs(got1[k] - want1[k]).max())
                 for k in got1) <= 2 * LR
      assert _share(got1, want1, got1) <= 2e-5
  np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
  got = {k: v.numpy() for k, v in r["params"].items()}
  want = {k: v.numpy() for k, v in
          from_jax_params(jax.device_get(params)).items()}
  assert max(float(np.abs(got[k] - want[k]).max())
             for k in got) <= 2 * LR * STEPS
  f64 = _steps_in_float64(r)
  assert _share(got, f64, f64) <= max(2 * _share(want, f64, f64), 2e-5)
  # the embeddings from the port's trained weights
  emb = np.asarray(net.apply({"params": to_jax_params(r["net"],
                                                     r["params"])}, X,
                             return_embedding=True))
  vecs = r["vecs"].numpy()
  assert vecs.shape == (len(raw), EMBED)
  np.testing.assert_allclose(vecs, emb, rtol=0,
                             atol=1e-5 * np.abs(emb).max())
  # PLDA on the port's embeddings
  held = spk >= SPEAKERS // 2
  plda = JaxPLDA(n_phi=min(chip_smoke.XV_PLDA["n_phi"], EMBED // 2),
                 n_iter=chip_smoke.XV_PLDA["n_iter"]).fit(
                     vecs[~held], spk[~held])
  v = vecs[held]
  scores = np.asarray(plda.score_trials(v[r["pairs"][:, 0]],
                                        v[r["pairs"][:, 1]]))
  mine = r["scores"].numpy()
  np.testing.assert_allclose(mine, scores, rtol=0,
                             atol=1e-9 * np.abs(scores).max())
  Pfa, Pmiss = det_curve(r["truth"], scores)[:2]
  assert abs(r["eer"] - compute_EER(Pfa, Pmiss)) <= 1e-9
  assert 0.0 <= r["mindcf"] <= 1.0
