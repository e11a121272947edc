"""The port's native corpus IO engine (``odin_tpu_torch/native.py`` over its
own copy of the source, ``csrc/odin_io.cpp``) against the pure-Python paths
and the JAX package's engine, on the CPU.

The library is built with g++ into ``build/odin_tpu_torch/`` (never the JAX
package's ``native/libodin_io.so``).  ``decode_wav`` of 16-bit mono wavs
equals ``read_wave`` bit for bit, ``pack_batch`` the zero-padded NumPy
block, ``gather`` numpy's fancy indexing (negative and out-of-range rows
included); every function equals the JAX package's on the same inputs, and
the NumPy fallbacks equal the library.  ``DataPipeline`` batches and
``AudioFeatureLoader``'s packed block go through it.
"""
import os
import wave

import numpy as np
import pytest

from odin_tpu import native as jax_native
from odin_tpu_torch import _build, native
from odin_tpu_torch.preprocessing.signal import get_window, segment_axis
from odin_tpu_torch.preprocessing.speech import read_wave

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.RandomState(21)


def _write_wav(path, y, sr=16000, width=2, channels=1):
  with wave.open(path, "wb") as w:
    w.setnchannels(channels)
    w.setsampwidth(width)
    w.setframerate(sr)
    if width == 2:
      w.writeframes((y * 32767).astype(np.int16).tobytes())
    else:
      w.writeframes(((y * 127) + 128).astype(np.uint8).tobytes())
  return path


@pytest.fixture
def no_library(monkeypatch):
  """The NumPy fallbacks, as on a machine with no compiler."""
  monkeypatch.setattr(native, "_LIB", None)
  monkeypatch.setattr(native, "_TRIED", True)


def test_library_is_built_under_build():
  assert native.native_available()
  path = os.path.realpath(native.library_file())
  assert path == os.path.realpath(str(_build.host_library_path("odin_io")))
  assert path.startswith(os.path.join(os.path.realpath(ROOT), "build") +
                         os.sep)
  assert "native" + os.sep + "libodin_io" not in path
  src = (_build.CSRC / "odin_io.cpp").read_text()
  assert "odin_gather" in src and "odin_pack_batch" in src


@pytest.mark.parametrize("width,channels", [(2, 1), (1, 1), (2, 2)])
def test_decode_matches_python(tmp_path, width, channels):
  y = np.clip(RNG.randn(8000 * channels) * 0.1, -1, 1).astype("f")
  p = _write_wav(str(tmp_path / "a.wav"), y, width=width, channels=channels)
  got, sr = native.decode_wav(p)
  want, sr2 = read_wave(p)
  if want.ndim > 1:
    want = want.mean(-1)
  assert sr == sr2 == 16000 and got.dtype == np.float32
  np.testing.assert_array_equal(got, want)  # bit for bit
  jax_y, jax_sr = jax_native.decode_wav(p)
  np.testing.assert_array_equal(got, jax_y)
  with open(p, "rb") as f:  # bytes in, as a path
    np.testing.assert_array_equal(native.decode_wav(f.read())[0], got)


def test_pack_batch(tmp_path):
  paths, refs = [], []
  for i in range(5):
    y = (RNG.randn(4000 + 500 * i) * 0.1).astype("f")
    paths.append(_write_wav(str(tmp_path / f"u{i}.wav"), y))
    refs.append(read_wave(paths[-1])[0])
  batch, lengths, srs = native.pack_batch(paths, 6000)
  want = np.zeros((5, 6000), np.float32)
  for i, y in enumerate(refs):
    want[i, :min(len(y), 6000)] = y[:6000]
  np.testing.assert_array_equal(batch, want)
  np.testing.assert_array_equal(lengths, [min(len(y), 6000) for y in refs])
  np.testing.assert_array_equal(srs, [16000] * 5)
  for got, ref in zip((batch, lengths, srs),
                      jax_native.pack_batch(paths, 6000)):
    np.testing.assert_array_equal(got, ref)
  for n_threads in (1, 3):
    np.testing.assert_array_equal(
        native.pack_batch(paths, 6000, n_threads=n_threads)[0], batch)
  _, lengths2, _ = native.pack_batch(
      paths[:1] + [str(tmp_path / "nope.wav")], 8000)
  assert lengths2[1] == 0


def test_fallbacks_equal_the_library(tmp_path, no_library):
  ys = [(RNG.randn(3000 + 700 * i) * 0.1).astype("f") for i in range(3)]
  paths = [_write_wav(str(tmp_path / f"u{i}.wav"), y)
           for i, y in enumerate(ys)]
  assert not native.native_available() and native.load_native() is None
  fallback = native.pack_batch(paths, 4000)
  decoded = native.decode_wav(paths[0])[0]
  frames = native.frame_signal_native(ys[1], 400, 160,
                                      get_window("hann", 400).astype("f"))
  arr = RNG.rand(50, 4).astype("f")
  idx = RNG.randint(0, 50, 70)
  gathered = native.gather(arr, idx)
  native._TRIED, native._LIB = False, None
  assert native.native_available()
  for got, want in zip(native.pack_batch(paths, 4000), fallback):
    np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(native.decode_wav(paths[0])[0], decoded)
  np.testing.assert_allclose(
      native.frame_signal_native(ys[1], 400, 160,
                                 get_window("hann", 400).astype("f")),
      frames, rtol=0, atol=1e-7)
  np.testing.assert_array_equal(native.gather(arr, idx), gathered)


def test_frame_signal_matches_segment_axis():
  y = RNG.randn(16000).astype("f")
  w = get_window("hann", 400).astype("f")
  f_native = native.frame_signal_native(y, 400, 160, w)
  np.testing.assert_allclose(f_native, segment_axis(y, 400, 160) * w,
                             atol=1e-6)
  np.testing.assert_array_equal(f_native,
                                jax_native.frame_signal_native(y, 400, 160, w))
  np.testing.assert_array_equal(native.frame_signal_native(y, 400, 160),
                                segment_axis(y, 400, 160))
  assert native.frame_signal_native(y[:100], 400, 160).shape == (0, 400)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int16,
                                   np.float64, np.bool_])
def test_gather_matches_numpy(dtype):
  rng = np.random.RandomState(0)
  arr = (rng.rand(100, 7, 3) * 100).astype(dtype)
  idx = rng.randint(0, 100, 333)
  np.testing.assert_array_equal(native.gather(arr, idx), arr[idx])
  np.testing.assert_array_equal(native.gather(arr, idx),
                                jax_native.gather(arr, idx))


def test_gather_edges():
  rng = np.random.RandomState(1)
  arr = rng.rand(50, 4).astype("f")
  idx = rng.randint(0, 50, 16)
  out = np.empty((16, 4), np.float32)
  assert native.gather(arr, idx, out=out) is out
  np.testing.assert_array_equal(out, arr[idx])
  nc = arr[:, ::2]
  np.testing.assert_array_equal(native.gather(nc, idx), nc[idx])
  neg = np.array([-1, 0, -50, 3])
  np.testing.assert_array_equal(native.gather(arr, neg), arr[neg])
  with pytest.raises(IndexError):
    native.gather(arr, np.array([0, 50]))
  vec = rng.rand(50)
  np.testing.assert_array_equal(native.gather(vec, idx), vec[idx])
  objs = np.array([object() for _ in range(5)], dtype=object)
  assert list(native.gather(objs, [4, 0])) == [objs[4], objs[0]]
  assert native.gather(arr, np.array([], np.int64)).shape == (0, 4)


def test_pipeline_gathers_through_the_library(monkeypatch):
  from odin_tpu_torch.fuel.pipeline import DataPipeline
  calls = []
  real = native.gather
  monkeypatch.setattr(native, "gather",
                      lambda a, i, **k: calls.append(len(i)) or real(a, i))
  rng = np.random.RandomState(3)
  data = rng.rand(40, 5).astype("f")
  labels = np.arange(40)
  batches = list(DataPipeline((data, labels), batch_size=8, shuffle=True,
                              seed=3, prefetch=0))
  order = np.random.RandomState(3).permutation(40)
  np.testing.assert_array_equal(np.concatenate([b[0] for b in batches]),
                                data[order])
  np.testing.assert_array_equal(np.concatenate([b[1] for b in batches]),
                                labels[order])
  assert calls == [8] * 10


def test_audio_feature_loader_packs_natively(tmp_path, monkeypatch):
  """A corpus of wav paths is packed by pack_batch, into the same block
  read_wave gives."""
  from odin_tpu_torch.fuel.audio_data import AudioFeatureLoader
  paths = [_write_wav(str(tmp_path / f"u{i}.wav"),
                      (RNG.randn(12000 + 900 * i) * 0.1).astype("f"))
           for i in range(4)]
  calls = []
  real = native.pack_batch
  monkeypatch.setattr(native, "pack_batch",
                      lambda p, t, **k: calls.append(len(p)) or real(p, t))
  loader = AudioFeatureLoader(paths, feature="mspec", max_duration=1.0,
                              device="cpu")
  batch, lengths = loader._pack()
  assert calls == [4]
  want = np.zeros_like(batch)
  for i, p in enumerate(paths):
    y = read_wave(p)[0][:batch.shape[1]]
    want[i, :len(y)] = y
    assert lengths[i] == len(y)
  np.testing.assert_array_equal(batch, want)
  with pytest.raises(ValueError, match="sample-rate"):
    AudioFeatureLoader([_write_wav(str(tmp_path / "r.wav"),
                                   np.zeros(8000, "f"), sr=8000)],
                       max_duration=1.0, device="cpu")._pack()
