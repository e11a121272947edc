"""Native replacements for the reference's openSMILE subprocess wrappers
(a copy of ``odin_tpu/preprocessing/opensmile.py``, host NumPy).

Reference: ``odin/preprocessing/_opensmile.py`` (412 LoC) shells out to the
external openSMILE binary with templated ``.cfg`` files for pitch (SHS/ACF),
F0, auditory loudness, and LSTM speech-activity detection, then parses the
CSV output (``_opensmile.py:65-178``).  SURVEY.md §2.0 calls for native
reimplementation: here every feature is computed in-process by the NumPy
kernels in ``odin_tpu_torch.preprocessing.signal`` (`shs_pitch`, `loudness`,
`intensity`, `pitch_track`, `vad_energy`) — same class names, same output
dict keys (``pitch``, ``f0``, ``loudness``, ``sap``, ``sad``), no external
binary, no temp files.

Deviations (documented, by design):
- `openSMILEsad`'s pretrained LSTM (``lstmvad_rplp18d_12.net``) is replaced
  by the GMM log-energy posterior (no bundled weights offline); output stays
  in openSMILE's [-1, 1] range so `threshold` semantics are preserved.
- `method='acf'` pitch maps to the YIN estimator (`signal.pitch_track`) —
  YIN is the modern cumulative-normalized form of the ACF method.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

from odin_tpu_torch.preprocessing import signal as S
from odin_tpu_torch.preprocessing._mixture import GaussianMixture
from odin_tpu_torch.preprocessing.base import Extractor
from odin_tpu_torch.preprocessing.speech import _to_samples

__all__ = ["openSMILEpitch", "openSMILEf0", "openSMILEloudness",
           "openSMILEsad"]


class openSMILEpitch(Extractor):
  """Pitch + optional f0 / loudness / voicing-probability columns
  (reference ``_opensmile.py:246-376``).

  ``method='shs'`` uses subharmonic summation (`signal.shs_pitch`);
  ``method='acf'`` uses YIN.  Output keys mirror the reference:
  ``pitch`` always, plus ``f0``, ``loudness``, ``sap`` when requested —
  each a (T, 1) float32 column.
  """

  def __init__(self, frame_length=0.025, step_length=None,
               fmin: float = 52.0, fmax: float = 620.0,
               voicingCutoff_pitch: float = 0.7,
               f0min: float = 64.0, f0max: float = 400.0,
               voicingCutoff_f0: float = 0.45,
               method: str = "shs", f0: bool = False,
               loudness: bool = False, voiceProb: bool = False):
    out = ["pitch"] + (["f0"] if f0 else []) + \
        (["loudness"] if loudness else []) + (["sap"] if voiceProb else [])
    super().__init__(output_name=tuple(out))
    self.frame_length = frame_length
    self.step_length = (frame_length / 4 if step_length is None
                        else step_length)
    self.fmin, self.fmax = float(fmin), float(fmax)
    self.voicingCutoff_pitch = float(np.clip(voicingCutoff_pitch, 0.0, 1.0))
    self.f0min, self.f0max = float(f0min), float(f0max)
    self.voicingCutoff_f0 = float(np.clip(voicingCutoff_f0, 0.0, 1.0))
    method = str(method).lower()
    if method not in ("shs", "acf"):
      raise ValueError("only 'shs' and 'acf' methods are supported")
    self.method = method
    self.f0 = bool(f0)
    self.loudness = bool(loudness)
    self.voiceProb = bool(voiceProb)

  def _pitch(self, y, sr, frame, step, fmin, fmax, cutoff):
    if self.method == "shs":
      return S.shs_pitch(y, sr, step, frame_length=frame, fmin=fmin,
                         fmax=fmax, voicing_threshold=cutoff, otype="pitch")
    f0 = S.pitch_track(y, sr, step, frame_length=frame, fmin=fmin, fmax=fmax,
                       otype="f0")
    _, voic = S.shs_pitch(y, sr, step, frame_length=frame, fmin=fmin,
                          fmax=fmax, voicing_threshold=cutoff, otype="f0")
    n = min(len(f0), len(voic))
    f0, voic = f0[:n], voic[:n]
    return np.where(voic >= cutoff, f0, 0.0).astype("float32"), voic

  def transform(self, X):
    feat = X if isinstance(X, dict) else {"raw": X}
    sr = feat.get("sr", 16000)
    y = feat["raw"]
    frame = _to_samples(self.frame_length, sr)
    step = _to_samples(self.step_length, sr)
    pitch, sap = self._pitch(y, sr, frame, step, self.fmin, self.fmax,
                             self.voicingCutoff_pitch)
    out = dict(feat)
    out["pitch"] = pitch[:, None]
    if self.f0:
      f0, _ = self._pitch(y, sr, frame, step, self.f0min, self.f0max,
                          self.voicingCutoff_f0)
      out["f0"] = f0[:len(pitch), None]
    if self.loudness:
      loud = S.intensity(y, sr, frame, step)
      out["loudness"] = loud[:len(pitch), None]
    if self.voiceProb:
      out["sap"] = sap[:, None]
    return out


class openSMILEf0(Extractor):
  """F0 track via subharmonic summation (reference ``_opensmile.py:179``,
  ``openSMILEf0.cfg``): raw f0 in [fmin, fmax], zeroed where the voicing
  probability is below `voicingCutoff`.  Output: ``f0`` (T, 1)."""

  def __init__(self, frame_length=0.025, step_length=None,
               fmin: float = 52.0, fmax: float = 620.0,
               voicingCutoff: float = 0.7):
    super().__init__(output_name=("f0",))
    self.frame_length = frame_length
    self.step_length = (frame_length / 4 if step_length is None
                        else step_length)
    self.fmin, self.fmax = float(fmin), float(fmax)
    self.voicingCutoff = float(np.clip(voicingCutoff, 0.0, 1.0))

  def transform(self, X):
    feat = X if isinstance(X, dict) else {"raw": X}
    sr = feat.get("sr", 16000)
    f0, _ = S.shs_pitch(feat["raw"], sr,
                        _to_samples(self.step_length, sr),
                        frame_length=_to_samples(self.frame_length, sr),
                        fmin=self.fmin, fmax=self.fmax,
                        voicing_threshold=self.voicingCutoff, otype="pitch")
    out = dict(feat)
    out["f0"] = f0[:, None]
    return out


class openSMILEloudness(Extractor):
  """Auditory-band loudness (reference ``_opensmile.py:210-245``): mel-band
  intensities -> Zwicker specific loudness ``(I_b/1e-6)^0.3`` averaged over
  `nmel` bands.  ``to_intensity=True`` multiplies by 60 and renames the
  output to ``intensity`` — the reference's exact post-processing."""

  def __init__(self, frame_length=0.025, step_length=None, nmel: int = 40,
               fmin: float = 20.0, fmax: Optional[float] = None,
               to_intensity: bool = False):
    super().__init__(
        output_name=("intensity" if to_intensity else "loudness",))
    self.frame_length = frame_length
    self.step_length = (frame_length / 4 if step_length is None
                        else step_length)
    self.nmel = int(nmel)
    self.fmin, self.fmax = float(fmin), fmax
    self.to_intensity = bool(to_intensity)

  def transform(self, X):
    feat = X if isinstance(X, dict) else {"raw": X}
    sr = feat.get("sr", 16000)
    L = S.loudness(feat["raw"], sr,
                   frame_length=_to_samples(self.frame_length, sr),
                   step_length=_to_samples(self.step_length, sr),
                   n_mels=self.nmel, fmin=self.fmin, fmax=self.fmax)
    out = dict(feat)
    name = self.output_name[0]
    out[name] = (L * 60.0 if self.to_intensity else L)[:, None]
    return out


class openSMILEsad(Extractor):
  """Speech-activity score per frame in [-1, 1]
  (reference ``_opensmile.py:377-412``).

  The reference runs a pretrained openSMILE LSTM (downloaded weights);
  natively we emit ``2 p - 1`` where p is the posterior probability of the
  highest-mean component of a GMM fit on normalized log-energy (the same
  model family as `SADgmm` / ``signal.vad_energy``, scikit-learn's EM and
  k-means seeding carried in NumPy) so the reference's
  [-1, 1] `threshold` semantics carry over.  With `threshold` set the
  output becomes boolean.
  """

  def __init__(self, frame_length=0.025, step_length=None,
               threshold: Optional[float] = None, nb_mixture: int = 3,
               nb_train_it: int = 25, output_name: str = "sad"):
    super().__init__(output_name=(output_name,))
    self.frame_length = frame_length
    self.step_length = (frame_length / 4 if step_length is None
                        else step_length)
    self.threshold = (None if threshold is None
                      else float(np.clip(threshold, -1.0, 1.0)))
    self.nb_mixture = int(nb_mixture)
    self.nb_train_it = int(nb_train_it)

  def transform(self, X):
    feat = X if isinstance(X, dict) else {"raw": X}
    sr = feat.get("sr", 16000)
    frames = S.segment_axis(np.asarray(feat["raw"], np.float64),
                            _to_samples(self.frame_length, sr),
                            _to_samples(self.step_length, sr), end="pad")
    log_e = S.get_energy(frames, log=True).ravel()
    e = (log_e - log_e.mean()) / max(log_e.std(), 1e-8)
    gmm = GaussianMixture(n_components=self.nb_mixture,
                          max_iter=self.nb_train_it, random_state=0)
    gmm.fit(e[:, None])
    post = gmm.predict_proba(e[:, None])[:, gmm.means_.ravel().argmax()]
    score = (2.0 * post - 1.0).astype("float32")
    out = dict(feat)
    name = self.output_name[0]
    out[name] = (score >= self.threshold if self.threshold is not None
                 else score)
    return out
