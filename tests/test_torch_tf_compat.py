"""The port's tf.signal path (``TFCompatConfig``, ``tf_mel_matrix``,
``tf_signal_features``) against the JAX package's on the CPU, on audio made
with numpy from a seed.

Limits: ``tf_mel_matrix`` within 1e-7 (both are the same float64 NumPy
computation rounded to float32); every key of ``tf_signal_features`` within
the JAX package's tf.signal parity limits (tests/test_tf_signal_parity.py):
rtol 1e-4 with atol 2e-3 on ``stft_re``/``stft_im``/``spec``/``mels`` and
5e-3 on ``mfcc``; the frame mask equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from odin_tpu.ops import features as jf
from odin_tpu_torch.ops import features as tf

torch.set_num_threads(2)

SR = 8000
CFG = dict(frame_length=256, frame_step=80, sample_rate=SR,
           num_mel_bins=20, lower_edge_hertz=125.0, upper_edge_hertz=3800.0)
LIMITS = {"stft_re": 2e-3, "stft_im": 2e-3, "spec": 2e-3, "mels": 2e-3,
          "mfcc": 5e-3}


def _utterances(n=3, T=4000, seed=0):
  """Tones of different amplitudes, so the per-utterance dB floor bites."""
  rng = np.random.RandomState(seed)
  t = np.arange(T) / SR
  return np.stack([(np.sin(2 * np.pi * (200.0 + 700.0 * i) * t) *
                    (0.1 + 0.4 * i) + 0.01 * rng.randn(T)).astype(np.float32)
                   for i in range(n)])


@pytest.mark.parametrize("args", [
    (20, 129, 8000, 125.0, 3800.0), (40, 257, 16000, 64.0, 7800.0),
    (80, 513, 22050, 0.0, 11025.0)])
def test_tf_mel_matrix_matches_jax(args):
  got, want = tf.tf_mel_matrix(*args), jf.tf_mel_matrix(*args)
  assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_config_matches_jax():
  for kw in (CFG, dict(frame_length=400, frame_step=160, fft_length=400,
                       sample_rate=16000, num_cepstral=13, top_DB=None)):
    a, b = tf.TFCompatConfig(**kw), jf.TFCompatConfig(**kw)
    assert vars(a).keys() >= {"fft_length", "top_DB", "num_cepstral"}
    for k in ("frame_length", "frame_step", "fft_length", "sample_rate",
              "power", "top_DB", "num_mel_bins", "num_cepstral", "log_mels",
              "lower_edge_hertz", "upper_edge_hertz"):
      assert getattr(a, k) == getattr(b, k), k
    for k in ("window_fn", "mel_weight", "mfcc_basis"):
      np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert a.n_frames(4000) == b.n_frames(4000)


@pytest.mark.parametrize("log_mels", [False, True])
@pytest.mark.parametrize("power", [2.0, 1.0])
@pytest.mark.parametrize("ragged", [False, True])
def test_tf_signal_features_match_jax(log_mels, power, ragged):
  kw = dict(CFG, log_mels=log_mels, power=power, num_cepstral=13)
  y = _utterances()
  lengths = np.array([4000, 3100, 2200], np.int32) if ragged else None
  want = jf.tf_signal_features(
      jnp.asarray(y), jf.TFCompatConfig(**kw),
      lengths=None if lengths is None else jnp.asarray(lengths))
  got = tf.tf_signal_features(y, tf.TFCompatConfig(**kw), lengths=lengths,
                              device="cpu")
  assert set(got) == set(want)
  np.testing.assert_array_equal(got["frame_mask"].numpy(),
                                np.asarray(want["frame_mask"]))
  for key, atol in LIMITS.items():
    g, w = got[key].numpy(), np.asarray(want[key])
    assert g.shape == w.shape, key
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol, err_msg=key)


def test_one_dimensional_input_and_cuda_without_a_card():
  cfg = tf.TFCompatConfig(**CFG)
  out = tf.tf_signal_features(_utterances(1)[0], cfg, device="cpu")
  assert out["mels"].shape == (1, cfg.n_frames(4000), 20)
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
      tf.tf_signal_features(_utterances(1), cfg)
