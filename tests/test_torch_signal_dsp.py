"""The port's DSP library (``odin_tpu_torch/preprocessing/signal.py``)
against the JAX package's ``odin_tpu/preprocessing/signal.py`` on the CPU.

Every public function is a copy, so the same numpy inputs (made from a
seed) give equal outputs bit for bit.  The one real port is ``vad_energy``:
scikit-learn's ``GaussianMixture`` EM carried in NumPy float64
(``preprocessing/_mixture.py``); it is held to scikit-learn's within 1e-9 on
the threshold, and its labels are equal but for frames within 1e-9 of the
threshold.  The accuracy checks of tests/test_signal_extras.py (pitch, CQT,
stack/resample/split, spectra) are repeated on the port.
"""
import os

import numpy as np
import pytest

from odin_tpu.preprocessing import signal as J
from odin_tpu_torch.preprocessing import signal as P
from torch_speech_common import SR, assert_same, synth_speech

VAD_TOL = 1e-9


def _y(n=8000, seed=0):
  return synth_speech(n, seed=seed)


def _frames(seed=0):
  return J.segment_axis(_y(seed=seed), 400, 160)


def _spec(seed=0):
  return np.abs(J.stft(_y(seed=seed), 400, 160, 512)) ** 2


def _feats(seed=0, n=120, d=13):
  return np.random.RandomState(seed).randn(n, d).astype("f")


# (name, args builder, kwargs): each call runs in both packages
CASES = [
    ("hz2mel", lambda: ([0.0, 500.0, 1000.0, 7999.0],), {}),
    ("mel2hz", lambda: (np.linspace(0, 40, 9),), {}),
    ("mel_filters", lambda: (SR, 512, 40, 64.0, 7000.0), {}),
    ("dct_filters", lambda: (21, 40), {}),
    ("get_window", lambda: ("hamm", 400), {}),
    ("segment_axis", lambda: (_y(), 400, 160), {}),
    ("segment_axis", lambda: (_y(8001), 400, 160), {"end": "pad"}),
    ("segment_axis", lambda: (_y(8001), 400, 160),
     {"end": "wrap", "pad_mode": "pre"}),
    ("segment_axis", lambda: (_feats(), 5, 2), {"axis": 0}),
    ("get_energy", lambda: (_frames(),), {}),
    ("get_energy", lambda: (_frames(),), {"log": False}),
    ("stft", lambda: (_y(), 400, 160, 512), {}),
    ("stft", lambda: (_y(),), {"frame_length": 400, "window": "hamm",
                               "padding": True, "energy": True}),
    ("stft", lambda: (_frames(),), {"n_fft": 512, "window": None}),
    ("istft", lambda: (J.stft(_y(), 400, 100, 512), 400, 100), {}),
    ("istft", lambda: (J.stft(_y(), 400, None, 512, padding=True), 400),
     {"padding": True}),
    ("griffin_lim", lambda: (np.abs(J.stft(_y(4000), 256, 64, 256)), 256, 64),
     {"n_iter": 4}),
    ("ispec", lambda: (_spec(), 400, 160), {"nb_iter": 3}),
    ("ispec", lambda: (J.power2db(_spec()), 400, 160),
     {"nb_iter": 2, "db": True, "normalize": False, "de_preemphasis": None}),
    ("power_spectrogram", lambda: (J.stft(_y(), 400, 160, 512),), {}),
    ("power_spectrogram", lambda: (J.stft(_y(), 400, 160, 512), 1.0), {}),
    ("power2db", lambda: (_spec(),), {}),
    ("power2db", lambda: (_spec(),), {"ref": np.max, "top_db": None}),
    ("db2power", lambda: (J.power2db(_spec()),), {}),
    ("mels_spectrogram", lambda: (_spec(), SR, 40), {}),
    ("mels_spectrogram", lambda: (_spec(), SR, None),
     {"fmin": 0, "fmax": 4000, "top_db": 60.0}),
    ("ceps_spectrogram", lambda: (J.mels_spectrogram(_spec(), SR, 40), 20),
     {}),
    ("ceps_spectrogram", lambda: (J.mels_spectrogram(_spec(), SR, 40), 13),
     {"remove_first_coef": False}),
    ("spectra", lambda: (SR, 400), {"y": _y(), "n_mels": 40, "n_ceps": 20}),
    ("spectra", lambda: (SR, 400), {"S": _spec(), "n_mels": 24, "power": 1,
                                    "log": False}),
    ("pre_emphasis", lambda: (_y(),), {}),
    ("pre_emphasis", lambda: (_feats(),), {"coeff": 0.9}),
    ("delta", lambda: (_feats(),), {}),
    ("delta", lambda: (_feats(),), {"width": 5, "order": 2}),
    ("delta", lambda: (_feats().T,), {"order": 2, "axis": 1}),
    ("shifted_deltas", lambda: (_feats(),), {}),
    ("shifted_deltas", lambda: (_feats(n=10),), {"N": 5, "d": 2, "P": 2,
                                                 "k": 4}),
    ("mvn", lambda: (_feats(),), {}),
    ("mvn", lambda: (_feats(),), {"varnorm": False,
                                  "indices": _feats(1)[:, 0] > 0}),
    ("wmvn", lambda: (_feats(n=400),), {"w": 31}),
    ("wmvn", lambda: (_feats(n=400),), {"w": 31, "varnorm": False}),
    ("wmvn", lambda: (_feats(n=400),),
     {"w": 31, "indices": _feats(2, n=400)[:, 0] > -0.5}),
    ("wmvn", lambda: (_feats(n=20),), {"w": 31}),
    ("rastafilt", lambda: (_feats(),), {}),
    ("smooth", lambda: (_y(500),), {}),
    ("smooth", lambda: (_y(500),), {"win": 7, "window": "blackman"}),
    ("smooth", lambda: (_y(500),), {"win": 2}),
    ("vad_threshold", lambda: (_frames().T,), {}),
    ("vad_threshold", lambda: (_frames().T, 20), {}),
    ("cqt_kernels", lambda: (SR,), {"n_bins": 48}),
    ("cqt", lambda: (_y(4000), SR, 512), {"n_bins": 48}),
    ("cqt", lambda: (np.stack([_y(4000), _y(4000, 1)], -1), SR, 256),
     {"fmin": 55.0, "n_bins": 36, "bins_per_octave": 12, "window": "hamm"}),
    ("stack_frames", lambda: (_feats(),), {"frame_length": 5}),
    ("stack_frames", lambda: (_feats(),), {"frame_length": 21,
                                           "step_length": 1,
                                           "keep_length": True}),
    ("resample", lambda: (_y(), SR, 8000), {}),
    ("resample", lambda: (_y(4410), 44100, SR), {}),
    ("vad_split_audio", lambda: (np.concatenate([_y(SR), np.zeros(SR // 2, "f"),
                                                 _y(SR, 1)]), SR),
     {"maximum_duration": 1.0}),
    ("vad_split_audio", lambda: (_y(), SR), {}),
    ("pitch_track", lambda: (_y(), SR, 160), {}),
    ("pitch_track", lambda: (_y(), SR, 160),
     {"otype": "f0", "fmin": 80.0, "fmax": 400.0, "threshold": 0.3}),
    ("shs_pitch", lambda: (_y(), SR, 160), {}),
    ("shs_pitch", lambda: (_y(), SR, 160),
     {"frame_length": 800, "otype": "f0", "n_harmonics": 8}),
    ("loudness", lambda: (_y(), SR, 400, 160), {}),
    ("loudness", lambda: (_y(300), SR, 400, 160), {"n_mels": 24,
                                                   "fmax": 6000.0}),
    ("intensity", lambda: (_y(), SR, 400, 160), {}),
    ("pad_sequences", lambda: ([_feats(n=5), _feats(1, n=9)],), {}),
    ("pad_sequences", lambda: ([_y(5), _y(9), _y(0)],),
     {"maxlen": 7, "padding": "post", "truncating": "post", "value": -1.0,
      "dtype": "float64"}),
    ("mel_frequencies", lambda: (), {}),
    ("mel_frequencies", lambda: (40, 64.0, 8000.0), {}),
    ("pad_center", lambda: (_y(100), 128), {}),
    ("pad_center", lambda: (_feats(), 20), {"axis": 1, "mode": "edge"}),
    ("loudness2intensity", lambda: (np.abs(_feats())[:, :1],), {}),
    ("loudness2intensity", lambda: (np.abs(_y(50)),), {}),
]


@pytest.mark.parametrize("name,args,kwargs", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_function_matches_jax(name, args, kwargs):
  a = args()
  assert_same(getattr(P, name)(*a, **kwargs), getattr(J, name)(*a, **kwargs),
              name)


def test_public_names_match():
  assert sorted(P.__all__) == sorted(J.__all__)
  for name in ("ispec", "spectra", "cqt_kernels", "cqt", "stack_frames",
               "resample", "vad_split_audio", "pitch_track", "set_vad_mode",
               "mel_frequencies", "pad_center", "loudness2intensity",
               "anything2wav"):
    assert callable(getattr(P, name)), name


def _energies():
  rng = np.random.RandomState(5)
  out = {}
  for seed in range(4):
    y = synth_speech(SR, seed=seed)
    out[f"speech{seed}"] = J.get_energy(J.segment_axis(y, 400, 160)).ravel()
  out["bimodal"] = np.concatenate([rng.randn(300) - 4, rng.randn(200) * 0.5])
  out["gaussian"] = rng.randn(500)
  out["short"] = rng.randn(3)
  out["two"] = rng.randn(2)
  out["one"] = rng.randn(1)
  out["constant"] = np.full(50, 2.5)
  out["2d"] = rng.randn(400, 1) * 3
  return out


@pytest.mark.parametrize("key", sorted(_energies()))
@pytest.mark.parametrize("distrib_nb", [2, 3, 4])
def test_vad_energy_matches_sklearn(key, distrib_nb):
  """The carried EM against scikit-learn's ``GaussianMixture`` (through
  JAX's ``vad_energy``), fallbacks to fewer components included."""
  e = _energies()[key]
  with np.errstate(all="ignore"):
    want_label, want_thr = J.vad_energy(e, distrib_nb=distrib_nb)
    got_label, got_thr = P.vad_energy(e, distrib_nb=distrib_nb)
  assert type(got_thr) is type(want_thr) or abs(want_thr - got_thr) == 0
  assert abs(float(got_thr) - float(want_thr)) <= VAD_TOL
  assert got_label.shape == want_label.shape
  assert got_label.dtype == want_label.dtype
  differ = got_label != want_label
  if differ.any():
    with np.errstate(all="ignore"):
      z = np.asarray(e, np.float64).ravel()
      z = (z - z.mean()) / z.std()
    assert np.all(np.abs(z[differ] - want_thr) <= VAD_TOL)


def test_vad_mode_is_module_state():
  e = _energies()["speech0"]
  try:
    for mode in (1.0, 2.4, 7.0):
      J.set_vad_mode(mode)
      P.set_vad_mode(mode)
      assert P._VAD_MODE == J._VAD_MODE
      want_label, want_thr = J.vad_energy(e)
      got_label, got_thr = P.vad_energy(e)
      assert abs(got_thr - want_thr) <= VAD_TOL
      np.testing.assert_array_equal(got_label, want_label)
    P.set_vad_mode("loud")  # ignored, as in JAX
    assert P._VAD_MODE == 2.4
  finally:
    J.set_vad_mode(2.0)
    P.set_vad_mode(2.0)


def test_anything2wav_needs_a_tool(monkeypatch, tmp_path):
  import shutil
  monkeypatch.setattr(shutil, "which", lambda name: None)
  for mod in (J, P):
    with pytest.raises(RuntimeError, match="sox or ffmpeg"):
      mod.anything2wav(str(tmp_path / "a.mp3"))


@pytest.mark.parametrize("f0", [100, 150, 220])
def test_pitch_track_accuracy(f0):
  t = np.arange(SR * 2) / SR
  rng = np.random.RandomState(0)
  y = np.sin(2 * np.pi * f0 * t).astype("f") + \
      0.01 * rng.randn(len(t)).astype("f")
  p = P.pitch_track(y, SR, step_length=160)
  assert abs(np.median(p[p > 0]) - f0) / f0 < 0.02
  noise = rng.randn(SR).astype("f") * 0.1
  assert (P.pitch_track(noise, SR, 160) > 0).mean() < 0.1


def test_stack_resample_split():
  X = np.arange(20).reshape(10, 2)
  s = P.stack_frames(X, 5, 2)
  assert s.shape == (3, 10)
  np.testing.assert_array_equal(s[0], np.arange(10))
  t = np.arange(SR) / float(SR)
  tone = np.sin(2 * np.pi * 440 * t).astype("f")
  down = P.resample(tone, SR, 8000)
  assert down.shape == (8000,)
  spec = np.abs(np.fft.rfft(down))
  assert abs(np.argmax(spec) * 8000 / len(down) - 440) < 2
  assert abs(down[200:-200].std() - tone.std()) < 0.01
  hi = np.sin(2 * np.pi * 5000 * t).astype("f")
  assert P.resample(hi, SR, 8000).std() < 0.05 * hi.std()
  y = np.sin(np.arange(SR) / 10).astype("f")
  long = np.concatenate([y, np.zeros(8000, "f"), y])
  chunks = P.vad_split_audio(long, SR, maximum_duration=1.5)
  assert all(len(c) <= 1.5 * SR for c in chunks)
  assert sum(len(c) for c in chunks) == len(long)


def test_cqt_peaks():
  t = np.arange(SR) / SR
  C = P.cqt(np.sin(2 * np.pi * 440 * t).astype("f"), SR, step_length=512)
  peak = int(np.median(C.argmax(1)))
  assert peak == round(np.log2(440 / 32.70) * 12)
  C2 = P.cqt(np.sin(2 * np.pi * 880 * t).astype("f"), SR, step_length=512)
  assert int(np.median(C2.argmax(1))) - peak == 12


def test_spectra_allinone_and_save_wave(tmp_path):
  from odin_tpu_torch.preprocessing.speech import read_wave, save_wave
  sr = 8000
  t = np.arange(sr, dtype=np.float64) / sr
  y = (0.5 * np.sin(2 * np.pi * 440 * t)).astype("f")
  out = P.spectra(sr, frame_length=200, y=y, n_mels=24, n_ceps=13)
  assert out["spec"].shape[1] == 257
  assert out["mspec"].shape[1] == 24 and out["mfcc"].shape[1] == 13
  assert out["energy"] is not None
  stft_out, _ = P.stft(y, frame_length=200, n_fft=512, energy=True)
  out2 = P.spectra(sr, frame_length=200, S=np.abs(stft_out) ** 2, n_mels=24,
                   power=1)
  np.testing.assert_allclose(out["mspec"], out2["mspec"], atol=1e-4)
  assert abs(int(np.argmax(out["spec"].mean(0))) - 28) <= 1
  p = str(tmp_path / "t.wav")
  save_wave(p, y, sr)
  y2, sr2 = read_wave(p)
  assert sr2 == sr and np.max(np.abs(y2 - y)) < 1e-4
  stereo = (np.stack([y, -y], -1) * 32767).astype(np.int16)
  save_wave(str(tmp_path / "s.wav"), stereo, sr)
  ys, _ = read_wave(str(tmp_path / "s.wav"))
  assert ys.shape == stereo.shape
