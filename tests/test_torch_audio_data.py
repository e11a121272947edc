"""The port's ``AudioFeatureLoader`` and ``synth_speaker_corpus`` against the
JAX package's on the CPU.

The corpus is the synthetic speaker corpus of both packages, which must be
bitwise equal from the same seed.  The loader runs in both compats, on wav
paths and on (array, sr) pairs.  Limits: ``compat="odin"``: ``mspec``
within 0.01 dB (the JAX package's log-mel limit), ``mfcc`` within 0.05
(tests/test_torch_features.py), ``mspec_cmvn`` within atol 1e-3 and rtol
1e-4 (the padded frames of the block hold normalized values in the
hundreds).  ``compat="tf"``: rtol 1e-4 with the atol of
tests/test_tf_signal_parity.py (2e-3 on ``mels``, 5e-3 on ``mfcc``); the dB
spectrum ``spec`` with atol 0.01 dB, since a bin in a spectral null
carries the packages' fp32 rounding magnified in dB (measured 7.8e-3 dB at
one of 226,674 values).
"""
import numpy as np
import pytest
import torch

from odin_tpu.fuel import audio_data as ja
from odin_tpu.preprocessing.speech import save_wave
from odin_tpu_torch.fuel import audio_data as ta

torch.set_num_threads(2)

SR = 16000


def test_synth_speaker_corpus_is_bitwise_equal():
  for kw in (dict(n_speakers=3, n_utt=2), dict(n_speakers=2, n_utt=3, seed=5,
                                              sr=8000, dur=1.0)):
    a, la = ta.synth_speaker_corpus(**kw)
    b, lb = ja.synth_speaker_corpus(**kw)
    np.testing.assert_array_equal(la, lb)
    assert len(a) == len(b)
    for x, y in zip(a, b):
      assert x.dtype == y.dtype == np.float32
      np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
  utts, labels = ja.synth_speaker_corpus(3, 3, seed=1, dur=1.0)
  lengths = np.random.RandomState(0).randint(SR // 2, SR + 1, len(utts))
  utts = [u[:n] for u, n in zip(utts, lengths)]
  root = tmp_path_factory.mktemp("wav")
  paths = [save_wave(str(root / f"u{i}.wav"), u, SR)
           for i, u in enumerate(utts)]
  return utts, labels, paths, str(root)


ODIN = [("mspec", 0.01, 0.0), ("mspec_cmvn", 1e-3, 1e-4),
        ("mfcc", 0.05, 0.0)]
TF = [("mels", 2e-3, 1e-4), ("mfcc", 5e-3, 1e-4), ("spec", 0.01, 1e-4)]


@pytest.mark.parametrize("source", ["paths", "directory", "arrays"])
@pytest.mark.parametrize("compat,feature,atol,rtol",
                         [("odin",) + f for f in ODIN] +
                         [("tf",) + f for f in TF])
def test_loader_matches_jax(corpus, source, compat, feature, atol, rtol):
  utts, labels, paths, root = corpus
  data = {"paths": paths, "directory": root,
          "arrays": [(u, SR) for u in utts]}[source]
  kw = dict(sr=SR, feature=feature, max_duration=1.0, compat=compat,
            labels=labels)
  want = ja.AudioFeatureLoader(data, **kw)
  got = ta.AudioFeatureLoader(data, device="cpu", **kw)
  assert got.shape == want.shape and got.name == want.name
  x, y = got.numpy("all")
  wx, wy = want.numpy("all")
  assert x.shape == wx.shape == (len(utts),) + got.shape
  np.testing.assert_array_equal(y, wy)
  np.testing.assert_allclose(x, wx, rtol=rtol, atol=atol, err_msg=feature)
  xb, yb = next(iter(got.create_dataset("train", batch_size=4,
                                        inc_labels=True, epochs=1,
                                        shuffle=False)))
  assert tuple(xb.shape) == (4,) + got.shape


def test_loader_resamples_arrays_and_rejects_wav_rates(corpus, tmp_path):
  utts, _, _, _ = corpus
  y8 = utts[0][::2].copy()
  got = ta.AudioFeatureLoader([(y8, 8000)], sr=SR, max_duration=1.0,
                              device="cpu").numpy("all", inc_labels=False)
  want = ja.AudioFeatureLoader([(y8, 8000)], sr=SR,
                               max_duration=1.0).numpy("all",
                                                       inc_labels=False)
  np.testing.assert_allclose(got, want, rtol=0, atol=0.01)
  path = save_wave(str(tmp_path / "u.wav"), y8, 8000)
  with pytest.raises(ValueError, match="sample-rate"):
    ta.AudioFeatureLoader([path], sr=SR, device="cpu").numpy("all")
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
      ta.AudioFeatureLoader([path], sr=SR)
