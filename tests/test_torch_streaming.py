"""The port's streaming features (``odin_tpu_torch.ops.streaming_features``)
against the JAX package's on the CPU, on audio made with numpy from a seed.

Limits are those of tests/test_ops_features.py:168-176: rtol 1e-4 with
atol 1e-5 on ``spec``, 1e-4 on ``mspec``, ``mfcc`` and ``energy``, 1e-3
on the CMVN features; the VAD and the frame mask equal.  The per-chunk raw
outputs are held to the same limits, and the finalized port features to the
port's own offline ``speech_features(use_pallas=False)``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from odin_tpu.ops import features as jf
from odin_tpu.ops import streaming_features as js
from odin_tpu_torch.ops import features as tf
from odin_tpu_torch.ops import streaming_features as ts

torch.set_num_threads(2)

LIMITS = [("spec", 1e-5), ("mspec", 1e-4), ("mfcc", 1e-4), ("energy", 1e-4),
          ("mspec_cmvn", 1e-3), ("mfcc_cmvn", 1e-3)]
RAW = [("spec", 1e-5), ("mspec_raw", 1e-4), ("mfcc_raw", 1e-4),
       ("energy", 1e-4)]


def _stream(cfg, y, chunk, init, step, finalize, to_array):
  state = init()
  outs = []
  for k in range(y.shape[1] // chunk):
    state, o = step(state, y[:, k * chunk:(k + 1) * chunk])
    outs.append({key: to_array(v) for key, v in o.items()})
  return outs, {key: to_array(v) for key, v in finalize(state, outs).items()}


def _port(cfg, y, chunk):
  outs, fin = _stream(
      cfg, y, chunk, lambda: ts.streaming_init(cfg, y.shape[0], device="cpu"),
      lambda s, c: ts.streaming_step(cfg, s, c),
      lambda s, outs: ts.streaming_finalize(
          cfg, s, [{k: torch.from_numpy(v) for k, v in o.items()}
                   for o in outs]),
      lambda v: v.numpy())
  return outs, fin


def _jax(cfg, y, chunk):
  step = jax.jit(lambda s, c: js.streaming_step(cfg, s, c))
  return _stream(
      cfg, y, chunk, lambda: js.streaming_init(cfg, y.shape[0]),
      lambda s, c: step(s, jnp.asarray(c)),
      lambda s, outs: js.streaming_finalize(
          cfg, s, [{k: jnp.asarray(v) for k, v in o.items()} for o in outs]),
      np.asarray)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("chunk", [800, 1600])
def test_streaming_matches_jax(dtype, chunk):
  cfg = jf.FeatureConfig()
  pcfg = tf.FeatureConfig()
  rs = np.random.RandomState(7 + chunk)
  y = (rs.randn(2, 8 * 1600) * 0.1).astype(np.float32)
  if dtype == "int16":
    y = (y * 32768.0).clip(-32768, 32767).astype(np.int16)
  j_outs, j_fin = _jax(cfg, y, chunk)
  p_outs, p_fin = _port(pcfg, y, chunk)
  for jo, po in zip(j_outs, p_outs):
    np.testing.assert_array_equal(po["frame_mask"], jo["frame_mask"])
    for key, tol in RAW:
      np.testing.assert_allclose(po[key], jo[key], rtol=1e-4, atol=tol,
                                 err_msg=key)
  np.testing.assert_array_equal(p_fin["frame_mask"], j_fin["frame_mask"])
  mask = p_fin["frame_mask"]
  for key, tol in LIMITS:
    np.testing.assert_allclose(p_fin[key][mask], j_fin[key][mask], rtol=1e-4,
                               atol=tol, err_msg=key)
  np.testing.assert_array_equal(p_fin["vad"], j_fin["vad"])


def test_streaming_matches_the_ports_offline_features():
  cfg = tf.FeatureConfig()
  C, K = 1600, 6
  rs = np.random.RandomState(3)
  y = (rs.randn(2, C * K) * 0.1).astype(np.float32)
  ref = {k: v.numpy() for k, v in tf.speech_features(
      y, cfg, device="cpu", use_pallas=False).items()}
  _, fin = _port(cfg, y, C)
  lead = ts.carry_samples(cfg) // cfg.step_length
  F = ref["mspec"].shape[1]
  assert not fin["frame_mask"][:, :lead].any()
  assert fin["frame_mask"][:, lead:lead + F].all()
  for key, tol in LIMITS:
    np.testing.assert_allclose(fin[key][:, lead:lead + F], ref[key],
                               rtol=1e-4, atol=tol, err_msg=key)
  np.testing.assert_array_equal(fin["vad"][:, lead:lead + F], ref["vad"])


def test_chunk_length_rules_raise_as_in_jax():
  cfg = tf.FeatureConfig()
  state = ts.streaming_init(cfg, 1, device="cpu")
  assert ts.carry_samples(cfg) == js.carry_samples(jf.FeatureConfig()) == 320
  with pytest.raises(ValueError, match="multiple of step"):
    ts.streaming_step(cfg, state, np.zeros((1, 1000), np.float32))
  with pytest.raises(ValueError, match="multiple of step"):
    js.streaming_step(jf.FeatureConfig(), js.streaming_init(
        jf.FeatureConfig(), 1), jnp.zeros((1, 1000), jnp.float32))
  with pytest.raises(ValueError, match="too short"):
    ts.streaming_step(cfg, state, np.zeros((1, 0), np.float32))
  # a one-dimensional chunk is one stream
  st, out = ts.streaming_step(cfg, state, np.zeros(1600, np.float32))
  assert out["mspec_raw"].shape == (1, 10, cfg.n_mels)
  assert st.n_consumed == 1600
