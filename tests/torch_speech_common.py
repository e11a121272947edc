"""Shared inputs of the speech front-end's port tests: synthetic speech
(tone bursts over silence, tests/test_preprocessing.py's `synth_speech`),
wav writing, and the standard extractor recipe built from either package's
stages."""
import wave

import numpy as np

SR = 16000


def synth_speech(n=16000, sr=SR, seed=0):
  """Tone bursts + silence + a little noise (float32)."""
  rng = np.random.RandomState(seed)
  t = np.arange(n) / sr
  y = np.zeros(n, "f")
  for start in range(0, n, 4000):
    if rng.rand() > 0.4:
      f0 = rng.uniform(100, 300)
      seg = slice(start, min(start + 3000, n))
      y[seg] += 0.3 * np.sin(2 * np.pi * f0 * t[seg]).astype("f")
  y += 0.01 * rng.randn(n).astype("f")
  return y


def write_wav(path, y, sr=SR):
  with wave.open(path, "wb") as w:
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(sr)
    w.writeframes((y * 32767).astype(np.int16).tobytes())
  return path


def standard_pipeline(M, deltas=False):
  """The reference's speaker-recognition recipe (``examples/fsdd_ivec.py:
  80-106``) from the stages of `M` (either package's ``preprocessing``),
  with Δ and ΔΔ of the MFCCs when `deltas`."""
  steps = [
      M.AudioReader(sr=SR),
      M.PreEmphasis(coeff=0.97),
      M.STFTExtractor(frame_length=0.025, step_length=0.010, n_fft=512,
                      window="hamm", energy=True),
      M.PowerSpecExtractor(power=2.0),
      M.MelsSpecExtractor(n_mels=24, fmin=64),
      M.MFCCsExtractor(n_ceps=20),
      M.SADgmm(),
  ]
  if deltas:
    steps.append(M.DeltaExtractor(input_name=("mfcc",), order=(0, 1, 2)))
  steps.append(M.AcousticNorm(input_name=("mspec", "mfcc")))
  return M.make_pipeline(steps)


def assert_same(a, b, name=""):
  """Equal bit for bit: arrays of one dtype and shape with equal bytes
  (NaNs in the same places), dicts key by key, scalars exactly."""
  if isinstance(a, dict):
    assert sorted(a) == sorted(b), (name, sorted(a), sorted(b))
    for k in a:
      assert_same(a[k], b[k], f"{name}.{k}")
  elif isinstance(a, (list, tuple)):
    assert len(a) == len(b), name
    for i, (x, y) in enumerate(zip(a, b)):
      assert_same(x, y, f"{name}[{i}]")
  elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        (name, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)
    assert np.ascontiguousarray(a).tobytes() == \
        np.ascontiguousarray(b).tobytes(), name  # signed zeros, NaN bits
  else:
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), \
        (name, type(a), type(b))
    assert a == b or (a != a and b != b), (name, a, b)
