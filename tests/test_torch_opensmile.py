"""The port's openSMILE replacements (``preprocessing/opensmile.py``)
against the JAX package's on the CPU.

``openSMILEpitch``, ``openSMILEf0`` and ``openSMILEloudness`` are NumPy
copies: equal bit for bit on the same signals.  ``openSMILEsad`` fits its
GMM with scikit-learn in the JAX package and with the EM and k-means
seeding carried in NumPy in the port (``preprocessing/_mixture.py``): its
scores are equal bit for bit on these signals too (the same seeding draws,
the same expressions).  The checks of tests/test_preprocessing.py's
`test_opensmile_native` are repeated on the port.
"""
import numpy as np
import pytest

import odin_tpu.preprocessing as J
import odin_tpu_torch.preprocessing as P
from odin_tpu_torch.preprocessing import signal as S
from torch_speech_common import SR, assert_same, synth_speech


def _harm(seconds=1.0):
  t = np.arange(int(seconds * SR)) / SR
  return (0.5 * np.sin(2 * np.pi * 220.0 * t) +
          0.25 * np.sin(2 * np.pi * 440.0 * t) +
          0.12 * np.sin(2 * np.pi * 660.0 * t)).astype("f")


CASES = [
    ("openSMILEpitch", {"frame_length": 0.05}, _harm),
    ("openSMILEpitch", {"frame_length": 0.05, "f0": True, "loudness": True,
                        "voiceProb": True}, _harm),
    ("openSMILEpitch", {"frame_length": 0.05, "method": "acf", "f0": True},
     _harm),
    ("openSMILEpitch", {"frame_length": 0.03, "step_length": 0.01,
                        "voicingCutoff_pitch": 0.5},
     lambda: synth_speech(SR, seed=2)),
    ("openSMILEf0", {"frame_length": 0.05}, _harm),
    ("openSMILEf0", {"frame_length": 0.04, "fmin": 80.0, "fmax": 300.0},
     lambda: synth_speech(SR, seed=3)),
    ("openSMILEloudness", {"frame_length": 0.05}, _harm),
    ("openSMILEloudness", {"frame_length": 0.025, "nmel": 24,
                           "to_intensity": True},
     lambda: synth_speech(SR, seed=4)),
    ("openSMILEsad", {"frame_length": 0.025}, lambda: synth_speech(2 * SR)),
    ("openSMILEsad", {"frame_length": 0.025, "threshold": 0.0},
     lambda: synth_speech(2 * SR, seed=1)),
    ("openSMILEsad", {"frame_length": 0.02, "step_length": 0.01,
                      "nb_mixture": 2, "nb_train_it": 10},
     lambda: synth_speech(SR, seed=5)),
    ("openSMILEsad", {"frame_length": 0.025, "nb_mixture": 4},
     lambda: synth_speech(2 * SR, seed=6)),
]


@pytest.mark.parametrize("name,kwargs,make", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_extractor_matches_jax(name, kwargs, make):
  feat = {"raw": make(), "sr": SR}
  assert_same(getattr(P, name)(**kwargs).transform(feat),
              getattr(J, name)(**kwargs).transform(feat), name)


def test_shs_kernel_accuracy():
  f0, voic = S.shs_pitch(_harm(2.0), SR, step_length=160, frame_length=800,
                         otype="pitch")
  mid = f0[5:-5]
  assert np.all(mid > 0)
  assert abs(np.median(mid) - 220.0) / 220.0 < 0.05
  assert voic[5:-5].min() > 0.5
  f0s, _ = S.shs_pitch(np.zeros(SR, "f"), SR, 160, frame_length=800)
  assert np.all(f0s == 0)


def test_opensmile_native():
  harm = _harm(2.0)
  feat = {"raw": harm, "sr": SR}
  out = P.openSMILEpitch(frame_length=0.05, f0=True, loudness=True,
                         voiceProb=True).transform(feat)
  for k in ("pitch", "f0", "loudness", "sap"):
    assert out[k].ndim == 2 and out[k].shape[1] == 1, k
  assert abs(np.median(out["pitch"][out["pitch"] > 0]) - 220.0) < 20.0
  out_acf = P.openSMILEpitch(frame_length=0.05, method="acf").transform(feat)
  p = out_acf["pitch"][out_acf["pitch"] > 0]
  assert len(p) and abs(np.median(p) - 220.0) < 20.0
  assert "f0" in P.openSMILEf0(frame_length=0.05).transform(feat)
  quiet = {"raw": 0.05 * harm, "sr": SR}
  L1 = P.openSMILEloudness(frame_length=0.05).transform(feat)["loudness"]
  L2 = P.openSMILEloudness(frame_length=0.05).transform(quiet)["loudness"]
  assert L1.mean() > L2.mean() > 0
  Li = P.openSMILEloudness(frame_length=0.05,
                           to_intensity=True).transform(feat)["intensity"]
  np.testing.assert_allclose(Li, L1 * 60.0, rtol=1e-6)
  y = synth_speech(SR * 2)
  score = P.openSMILEsad(frame_length=0.025).transform(
      {"raw": y, "sr": SR})["sad"].ravel()
  assert score.min() >= -1.0 and score.max() <= 1.0
  sad_b = P.openSMILEsad(frame_length=0.025, threshold=0.0).transform(
      {"raw": y, "sr": SR})
  assert sad_b["sad"].dtype == bool
  with pytest.raises(ValueError):
    P.openSMILEpitch(method="swipe")
