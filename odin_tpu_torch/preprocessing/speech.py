"""Audio readers and speech feature extractors: a copy of
``odin_tpu/preprocessing/speech.py``, so that the port never imports the JAX
package.

The readers (``read_wave``, ``read_wave_raw``, ``save_wave``,
``read_pcm``, ``read_sphere``, ``read``) and the extractor stages
(`AudioReader`, `Dithering`, `PreEmphasis`, `Framing`, `CalculateEnergy`,
`STFTExtractor`, `PowerSpecExtractor`, `MelsSpecExtractor`,
`MFCCsExtractor`, `Power2Db`, `SpectraExtractor`, `SADthreshold`,
`SADgmm`, `CQTExtractor`, `PitchExtractor`, `RASTAfilter`, `AcousticNorm`,
`Read3ColSAD`, `ApplyingSAD`, `AudioAugmentor`) are host NumPy, op for op
the JAX package's.  `BNFExtractor` runs its network with PyTorch on a
device, the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import io
import os
import wave
from typing import Callable, Optional, Tuple, Union

import numpy as np

from odin_tpu_torch.preprocessing import signal as S
from odin_tpu_torch.preprocessing.base import Extractor, ExtractorSignal

__all__ = [
    "read_wave", "read_wave_raw", "save_wave", "read_sphere", "read_pcm",
    "read", "audio_segmenter", "AudioReader", "Dithering", "PreEmphasis",
    "Framing", "CalculateEnergy", "STFTExtractor", "PowerSpecExtractor",
    "MelsSpecExtractor", "MFCCsExtractor", "SpectraExtractor", "Power2Db",
    "SADthreshold", "SADgmm", "CQTExtractor", "PitchExtractor",
    "RASTAfilter", "AcousticNorm", "Read3ColSAD", "ApplyingSAD",
    "BNFExtractor", "AudioAugmentor",
]


def read_wave(path_or_bytes) -> Tuple[np.ndarray, int]:
  """Minimal PCM wav reader (stdlib `wave` + numpy; the reference shells out
  to soundfile/sox, unavailable offline)."""
  if isinstance(path_or_bytes, bytes):
    fobj = io.BytesIO(path_or_bytes)
  else:
    fobj = path_or_bytes
  with wave.open(fobj, "rb") as w:
    sr = w.getframerate()
    n = w.getnframes()
    width = w.getsampwidth()
    channels = w.getnchannels()
    raw = w.readframes(n)
  dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
  y = np.frombuffer(raw, dtype=dtype).astype(np.float32)
  if width == 1:
    y = (y - 128.0) / 128.0
  else:
    # divide by 2^(bits-1) (matches the native decoder and libsndfile)
    y = y / float(np.iinfo(dtype).max + 1)
  if channels > 1:
    y = y.reshape(-1, channels)
  return y, sr


def read_wave_raw(path_or_bytes) -> Tuple[np.ndarray, int]:
  """PCM16 wav -> (int16 samples, sr) WITHOUT the float conversion — the
  raw-transfer ingest path (ship 2 bytes/sample to the device, rescale
  there; see `processor.batch_speech_features` raw policy).  Multi-channel
  audio falls back to the float reader (channel mixing needs floats)."""
  if isinstance(path_or_bytes, bytes):
    fobj = io.BytesIO(path_or_bytes)
  else:
    fobj = path_or_bytes
  with wave.open(fobj, "rb") as w:
    if w.getsampwidth() != 2 or w.getnchannels() != 1:
      y, sr = read_wave(path_or_bytes)
      if y.ndim > 1:
        y = y.mean(-1)
      return np.clip(y * 32768.0, -32768, 32767).astype(np.int16), sr
    sr = w.getframerate()
    raw = w.readframes(w.getnframes())
  return np.frombuffer(raw, dtype=np.int16), sr


def save_wave(path, y: np.ndarray, sr: int) -> str:
  """PCM16 wav writer — the inverse of `read_wave` (reference `save`,
  ``speech.py:127`` and `utils.save_wav`, ``utils/__init__.py:1379``).
  Float input in [-1, 1] is scaled to int16; int16 passes through."""
  y = np.asarray(y)
  if y.dtype != np.int16:
    y = np.clip(np.asarray(y, np.float64), -1.0, 1.0)
    y = np.round(y * 32767.0).astype(np.int16)
  channels = 1 if y.ndim == 1 else y.shape[1]
  with wave.open(path, "wb") as w:
    w.setnchannels(channels)
    w.setsampwidth(2)
    w.setframerate(int(sr))
    w.writeframes(y.tobytes())
  return path


def _ulaw_expand(u: np.ndarray) -> np.ndarray:
  """ITU-T G.711 mu-law expansion (uint8 codewords -> float in [-1, 1))."""
  u = (~u.astype(np.uint8)).astype(np.int32)
  sign = u & 0x80
  exponent = (u >> 4) & 0x07
  mantissa = u & 0x0F
  magnitude = ((mantissa << 3) + 0x84) << exponent
  magnitude -= 0x84
  pcm = np.where(sign, -magnitude, magnitude).astype(np.int16)
  return pcm.astype(np.float32) / 32768.0


def read_pcm(path_or_bytes, encode: Optional[str] = None
             ) -> Tuple[np.ndarray, Optional[int]]:
  """Headerless PCM (reference `_read_pcm`, ``speech.py:113-124``):
  int16 by default; `encode` 'ulaw' -> 8-bit mu-law at 8 kHz, 'vast' ->
  int16 at 44 kHz."""
  raw = (np.frombuffer(path_or_bytes, np.uint8)
         if isinstance(path_or_bytes, bytes)
         else np.fromfile(path_or_bytes, np.uint8))
  sr = None
  if encode is not None and "ulaw" in encode.lower():
    return _ulaw_expand(raw), 8000
  if encode is not None and "vast" in encode.lower():
    sr = 44000
  y = raw[: len(raw) // 2 * 2].view(np.int16).astype(np.float32) / 32768.0
  return y, sr


def read_sphere(path_or_bytes, raw: bool = False) -> Tuple[np.ndarray, int]:
  """NIST SPHERE (.sph) reader: parses the 1024-byte ASCII header
  (sample_rate / channel_count / sample_n_bytes / sample_byte_format /
  sample_coding) and decodes pcm or mu-law payloads.  The reference memmaps
  sphere files headers-and-all through `_read_pcm` (``speech.py:148-160``);
  this is the corrected, self-contained decode (shorten-compressed payloads
  are rejected explicitly).

  ``raw=True`` returns mu-law payloads as their uint8 G.711 codewords
  (mono only) instead of expanding on host — feed them straight to
  `ops.features.speech_features` / `batch_speech_features`, which expand
  ON DEVICE at a quarter of the fp32 transfer bytes (exact)."""
  data = (path_or_bytes if isinstance(path_or_bytes, bytes)
          else open(path_or_bytes, "rb").read())
  if not data.startswith(b"NIST_1A"):
    raise ValueError("not a NIST SPHERE file")
  header_size = int(data[8:16].split()[0])
  header = data[:header_size].decode("ascii", errors="replace")
  fields = {}
  for line in header.splitlines()[2:]:
    line = line.strip()
    if line == "end_head" or not line:
      break
    parts = line.split(None, 2)
    if len(parts) == 3:
      name, ftype, value = parts
      fields[name] = int(value) if ftype.startswith("-i") else value
  sr = int(fields.get("sample_rate", 8000))
  channels = int(fields.get("channel_count", 1))
  n_bytes = int(fields.get("sample_n_bytes", 2))
  coding = str(fields.get("sample_coding", "pcm")).lower()
  byte_format = str(fields.get("sample_byte_format", "01"))
  if "shorten" in coding or "embedded" in coding:
    raise ValueError(f"shorten-compressed sphere not supported: {coding}")
  payload = np.frombuffer(data, np.uint8, offset=header_size)
  if "ulaw" in coding or n_bytes == 1:
    if raw and channels == 1:
      return payload.copy(), sr
    y = _ulaw_expand(payload)
  else:
    y = payload[: len(payload) // 2 * 2].view(np.int16)
    if byte_format == "10":  # big-endian payload
      y = y.byteswap()
    y = y.astype(np.float32) / 32768.0
  if channels > 1:
    y = y[: len(y) // channels * channels].reshape(-1, channels)
  return y, sr


def read(path_or_file, encode: Optional[str] = None
         ) -> Tuple[np.ndarray, Optional[int]]:
  """Format-dispatching audio read (reference `read`,
  ``speech.py:127-170``): .wav -> RIFF, .sph -> NIST SPHERE,
  .pcm/.raw -> headerless PCM."""
  path = path_or_file if isinstance(path_or_file, str) else \
      getattr(path_or_file, "name", "")
  low = path.lower()
  if low.endswith(".pcm") or low.endswith(".raw"):
    return read_pcm(path_or_file, encode=encode)
  if low.endswith(".sph"):
    return read_sphere(path_or_file)
  if low.endswith(".wav") or not low:
    return read_wave(path_or_file)
  # sniff the magic bytes as a fallback
  with open(path, "rb") as f:
    magic = f.read(8)
  if magic.startswith(b"NIST_1A"):
    return read_sphere(path)
  if magic.startswith(b"RIFF"):
    return read_wave(path)
  return read_pcm(path, encode=encode)


def audio_segmenter(files, outpath, max_duration,
                    sr: Optional[int] = None, sr_new: Optional[int] = None,
                    override: bool = False) -> str:
  """Split each file into chunks of at most `max_duration` seconds and save
  them as ``<name>.<ID>.wav`` under `outpath`, plus a ``segments.csv``
  manifest (columns: segment origin start end, seconds).

  Reference: ``odin/preprocessing/speech.py:245-337`` — equal-size chunking
  via rounded ``np.linspace`` so every chunk is <= max_duration and the last
  chunk is not a sliver; if `outpath` already exists and ``override`` is
  False the existing manifest path is returned untouched (the reference's
  once-for-all contract: segment once, try many feature configs)."""
  import shutil
  info_path = os.path.join(str(outpath), "segments.csv")
  max_duration = int(max_duration)
  files = [files] if isinstance(files, str) else list(files)
  files = [f for f in files if os.path.isfile(f)]
  if os.path.isfile(outpath):
    raise ValueError(f"outpath at: {outpath} is a file.")
  if os.path.isdir(outpath):
    if not override:
      return info_path
    shutil.rmtree(outpath)
  os.makedirs(outpath)
  reader = AudioReader(sr=sr, sr_new=sr_new, remove_dc=False)
  seg_rows = []
  for f in files:
    out = reader.transform(f)
    y, file_sr = out["raw"], out["sr"]
    n_seg = int(np.ceil(y.shape[0] / (file_sr * max_duration)))
    cuts = [int(np.round(i)) for i in
            np.linspace(0, y.shape[0], num=n_seg + 1, endpoint=True)]
    base = os.path.basename(f)
    stem = base.rsplit(".", 1)[0]
    for idx, (s, e) in enumerate(zip(cuts, cuts[1:])):
      seg_name = f"{stem}.{idx}.wav"
      save_wave(os.path.join(outpath, seg_name), y[s:e], file_sr)
      seg_rows.append((seg_name, base, s / file_sr, e / file_sr))
  with open(info_path, "w") as fo:
    fo.write("segment origin start end\n")
    for seg, origin, s, e in seg_rows:
      fo.write(f"{seg} {origin} {s} {e}\n")
  return info_path


class AudioReader(Extractor):
  """Load audio: wav/sph/pcm path / (array, sr) tuple / dict; resample +
  remove DC (reference :345)."""

  def __init__(self, sr: Optional[int] = None, sr_new: Optional[int] = None,
               remove_dc: bool = True, dtype="float32"):
    super().__init__(output_name=("raw", "sr"))
    self.sr = sr
    self.sr_new = sr_new
    self.remove_dc = bool(remove_dc)
    self.dtype = dtype

  def transform(self, X):
    name = None
    sr = self.sr
    if isinstance(X, dict):
      name = X.get("name")
      if "sr" in X:
        sr = X["sr"]
      X = X.get("path", X.get("raw"))
    if isinstance(X, str):
      name = name or os.path.basename(X)
      y, sr_file = read(X)
      sr = sr_file if sr_file is not None else sr
      if sr is None:
        raise ExtractorSignal(
            f"sample rate unknown for headerless file {X}", action="error",
            extractor=self)
    elif isinstance(X, (tuple, list)) and len(X) == 2:
      y, sr = np.asarray(X[0]), int(X[1])
    else:
      y = np.asarray(X)
      if sr is None:
        raise ExtractorSignal("sample rate not provided for raw array input",
                              action="error", extractor=self)
    y = y.astype(self.dtype)
    if y.ndim > 1:
      y = y.mean(axis=-1)
    if self.remove_dc:
      y = y - np.mean(y)
    if self.sr_new is not None and sr != self.sr_new:
      from scipy.signal import resample_poly
      from math import gcd
      g = gcd(int(self.sr_new), int(sr))
      y = resample_poly(y, int(self.sr_new) // g, int(sr) // g)
      sr = int(self.sr_new)
    out = {"raw": y.astype(self.dtype), "sr": int(sr)}
    if name is not None:
      out["name"] = name
    return out


class Dithering(Extractor):
  """Add low-level noise (reference :512)."""

  def __init__(self, dither: float = 1.0, seed: int = 8):
    super().__init__(input_name=("raw",), output_name=("raw",))
    self.dither = float(dither)
    self.seed = int(seed)

  def _transform(self, X):
    (y,) = X
    rng = np.random.RandomState(self.seed)
    return y + self.dither * 1e-6 * rng.randn(*y.shape).astype(y.dtype)


class PreEmphasis(Extractor):
  """coeff 0.97 (reference :540)."""

  def __init__(self, coeff: float = 0.97):
    super().__init__(input_name=("raw",), output_name=("raw",))
    self.coeff = float(coeff)

  def _transform(self, X):
    (y,) = X
    return S.pre_emphasis(y, self.coeff).astype(y.dtype)


def _to_samples(value, sr):
  """second (float) or sample (int) -> samples (reference convention)."""
  if isinstance(value, float):
    return int(value * sr)
  return int(value)


class Framing(Extractor):
  """Reference :569."""

  def __init__(self, frame_length=0.025, step_length=0.010, end="cut"):
    super().__init__(output_name=("frames",))
    self.frame_length = frame_length
    self.step_length = step_length
    self.end = end

  def transform(self, X):
    feat = X if isinstance(X, dict) else {"raw": X}
    sr = feat.get("sr", 16000)
    frames = S.segment_axis(feat["raw"],
                            _to_samples(self.frame_length, sr),
                            _to_samples(self.step_length, sr),
                            end=self.end)
    out = dict(feat)
    out["frames"] = frames
    return out


class CalculateEnergy(Extractor):
  """Reference :623."""

  def __init__(self, log: bool = True, input_name="frames"):
    super().__init__(input_name=(input_name,), output_name=("energy",))
    self.log = bool(log)

  def _transform(self, X):
    (frames,) = X
    return S.get_energy(frames, log=self.log)


class STFTExtractor(Extractor):
  """Frame/step in seconds or samples -> complex STFT + optional log-energy
  (reference :655)."""

  def __init__(self, frame_length=0.025, step_length=0.010,
               n_fft: int = 512, window: str = "hamm", padding: bool = False,
               energy: bool = True):
    super().__init__(output_name=("stft", "energy"))
    self.frame_length = frame_length
    self.step_length = step_length
    self.n_fft = int(n_fft)
    self.window = window
    self.padding = bool(padding)
    self.energy = bool(energy)

  def transform(self, X):
    feat = X if isinstance(X, dict) else {"raw": X}
    sr = feat.get("sr", 16000)
    res = S.stft(feat["raw"],
                 frame_length=_to_samples(self.frame_length, sr),
                 step_length=_to_samples(self.step_length, sr),
                 n_fft=self.n_fft, window=self.window,
                 padding=self.padding, energy=self.energy)
    out = dict(feat)
    if self.energy:
      out["stft"], out["energy"] = res
    else:
      out["stft"] = res
    return out


class PowerSpecExtractor(Extractor):
  """|S|^p (reference :748)."""

  def __init__(self, power: float = 2.0, input_name="stft",
               output_name="spec"):
    super().__init__(input_name=(input_name,), output_name=(output_name,))
    self.power = float(power)

  def _transform(self, X):
    (stft_matrix,) = X
    return (np.abs(stft_matrix) ** self.power).astype("float32")


class MelsSpecExtractor(Extractor):
  """Reference :766."""

  def __init__(self, n_mels: int = 40, fmin: float = 64.0,
               fmax: Optional[float] = None, top_db: float = 80.0,
               input_name=("spec", "sr"), output_name="mspec"):
    super().__init__(input_name=input_name, output_name=(output_name,))
    self.n_mels = int(n_mels)
    self.fmin = fmin
    self.fmax = fmax
    self.top_db = top_db

  def _transform(self, X):
    spec, sr = X
    return S.mels_spectrogram(spec, sr, self.n_mels, fmin=self.fmin,
                              fmax=self.fmax, top_db=self.top_db
                              ).astype("float32")


class MFCCsExtractor(Extractor):
  """Reference :805; `first_coefficient_energy` replaces coef 0 with the
  log-energy."""

  def __init__(self, n_ceps: int = 20, remove_first_coef: bool = True,
               first_coefficient_energy: bool = False,
               input_name="mspec", output_name="mfcc"):
    super().__init__(input_name=(input_name,), output_name=(output_name,))
    self.n_ceps = int(n_ceps)
    self.remove_first_coef = bool(remove_first_coef)
    self.first_coefficient_energy = bool(first_coefficient_energy)

  def transform(self, X):
    feat = X if isinstance(X, dict) else {"raw": X}
    mfcc = S.ceps_spectrogram(feat[self.input_name[0]], self.n_ceps,
                              remove_first_coef=self.remove_first_coef)
    if self.first_coefficient_energy and "energy" in feat:
      mfcc = np.concatenate([feat["energy"][:len(mfcc)].reshape(-1, 1),
                             mfcc[:, 1:] if not self.remove_first_coef
                             else mfcc], axis=-1)
    out = dict(feat)
    out[self.output_name[0]] = mfcc.astype("float32")
    return out


class Power2Db(Extractor):
  """Reference :834."""

  def __init__(self, input_name=("spec",), top_db: float = 80.0):
    super().__init__(input_name=input_name)
    self.top_db = float(top_db)

  def _transform(self, X):
    return {k: S.power2db(x, top_db=self.top_db).astype("float32")
            for k, x in zip(self.input_name, X)}


class SpectraExtractor(Extractor):
  """All-in-one STFT -> spec/mspec/mfcc/energy (reference :849)."""

  def __init__(self, frame_length=0.025, step_length=0.010, n_fft: int = 512,
               window: str = "hamm", n_mels: int = 40, n_ceps: int = 20,
               fmin: float = 64.0, fmax: Optional[float] = None,
               top_db: float = 80.0, power: float = 2.0, log: bool = True,
               padding: bool = False):
    super().__init__()
    self.stft_ex = STFTExtractor(frame_length, step_length, n_fft, window,
                                 padding, energy=True)
    self.n_mels, self.n_ceps = int(n_mels), int(n_ceps)
    self.fmin, self.fmax, self.top_db = fmin, fmax, top_db
    self.power = power
    self.log = log

  def transform(self, X):
    feat = self.stft_ex.transform(X)
    sr = feat.get("sr", 16000)
    spec = np.abs(feat["stft"]) ** self.power
    feat["spec"] = (S.power2db(spec, top_db=self.top_db)
                    if self.log else spec).astype("float32")
    feat["mspec"] = S.mels_spectrogram(spec, sr, self.n_mels, fmin=self.fmin,
                                       fmax=self.fmax, top_db=self.top_db
                                       ).astype("float32")
    feat["mfcc"] = S.ceps_spectrogram(feat["mspec"], self.n_ceps
                                      ).astype("float32")
    return feat


class SADthreshold(Extractor):
  """Kaldi-style energy-threshold SAD with context voting
  (reference :1299-1437 — the numba kernel, vectorized with a windowed
  proportion vote)."""

  def __init__(self, energy_threshold: float = 0.55,
               energy_mean_scale: float = 0.5, context: int = 2,
               proportion_threshold: float = 0.12,
               input_name="energy", output_name="sad"):
    super().__init__(input_name=(input_name,), output_name=(output_name,))
    self.energy_threshold = float(energy_threshold)
    self.energy_mean_scale = float(energy_mean_scale)
    self.context = int(context)
    self.proportion_threshold = float(proportion_threshold)

  def _transform(self, X):
    (energy,) = X
    e = np.asarray(energy).ravel().astype(np.float64)
    thr = self.energy_threshold + self.energy_mean_scale * np.mean(e)
    above = (e > thr).astype(np.float64)
    # context window proportion vote: frame t is speech if the fraction of
    # above-threshold frames within +-context exceeds proportion_threshold
    w = 2 * self.context + 1
    kernel = np.ones(w) / w
    vote = np.convolve(above, kernel, mode="same")
    return (vote > self.proportion_threshold)


class SADgmm(Extractor):
  """3-component GMM on log-energy; highest-mean component = speech
  (reference :1439-1480 via `vad_energy`)."""

  def __init__(self, nb_mixture: int = 3, nb_train_it: int = 25,
               input_name="energy", output_name="sad"):
    super().__init__(input_name=(input_name,), output_name=(output_name,))
    self.nb_mixture = int(nb_mixture)
    self.nb_train_it = int(nb_train_it)

  def _transform(self, X):
    (energy,) = X
    label, _ = S.vad_energy(np.asarray(energy).ravel(),
                            distrib_nb=self.nb_mixture,
                            nb_train_it=self.nb_train_it)
    return label.astype(bool)


class CQTExtractor(Extractor):
  """Constant-Q spectrogram in dB (reference :932)."""

  def __init__(self, step_length=0.010, fmin: float = 32.70,
               n_bins: int = 84, bins_per_octave: int = 12,
               top_db: float = 80.0, output_name="cqt"):
    super().__init__(output_name=(output_name,))
    self.step_length = step_length
    self.fmin = float(fmin)
    self.n_bins = int(n_bins)
    self.bins_per_octave = int(bins_per_octave)
    self.top_db = float(top_db)

  def transform(self, X):
    feat = X if isinstance(X, dict) else {"raw": X}
    sr = feat.get("sr", 16000)
    C = S.cqt(feat["raw"], sr, _to_samples(self.step_length, sr),
              fmin=self.fmin, n_bins=self.n_bins,
              bins_per_octave=self.bins_per_octave)
    out = dict(feat)
    out[self.output_name[0]] = S.power2db(C ** 2, top_db=self.top_db
                                          ).astype("float32")
    return out


class PitchExtractor(Extractor):
  """YIN f0 track per frame (reference `openSMILE` pitch configs and
  ``signal.py:1904`` `pitch_track` — reimplemented natively, SURVEY §2.0)."""

  def __init__(self, step_length=0.010, fmin: float = 60.0,
               fmax: float = 260.0, threshold: float = 0.2,
               otype: str = "pitch", output_name="pitch"):
    super().__init__(output_name=(output_name,))
    self.step_length = step_length
    self.fmin, self.fmax = float(fmin), float(fmax)
    self.threshold = float(threshold)
    self.otype = otype

  def transform(self, X):
    feat = X if isinstance(X, dict) else {"raw": X}
    sr = feat.get("sr", 16000)
    p = S.pitch_track(feat["raw"], sr, _to_samples(self.step_length, sr),
                      fmin=self.fmin, fmax=self.fmax,
                      threshold=self.threshold, otype=self.otype)
    out = dict(feat)
    out[self.output_name[0]] = p[:, None]
    return out


class RASTAfilter(Extractor):
  """Reference :1483."""

  def __init__(self, input_name=("mfcc",)):
    super().__init__(input_name=input_name)

  def _transform(self, X):
    return {k: S.rastafilt(x).astype("float32")
            for k, x in zip(self.input_name, X)}


class AcousticNorm(Extractor):
  """MVN + windowed-MVN (w=301) over SAD frames (reference :1536)."""

  def __init__(self, input_name=("mspec", "mfcc"), mean_var_norm: bool = True,
               windowed_mean_var_norm: bool = False, win_length: int = 301,
               var_norm: bool = True, sad_name: Optional[str] = "sad"):
    super().__init__(input_name=input_name)
    self.mean_var_norm = bool(mean_var_norm)
    self.windowed_mean_var_norm = bool(windowed_mean_var_norm)
    self.win_length = int(win_length)
    self.var_norm = bool(var_norm)
    self.sad_name = sad_name

  def transform(self, X):
    feat = X if isinstance(X, dict) else {"raw": X}
    indices = feat.get(self.sad_name) if self.sad_name else None
    out = dict(feat)
    for name in self.input_name:
      if name not in feat or feat[name] is None:
        continue
      x = feat[name]
      idx = indices[:len(x)] if indices is not None else None
      if self.mean_var_norm:
        x = S.mvn(x, varnorm=self.var_norm, indices=idx)
      if self.windowed_mean_var_norm:
        x = S.wmvn(x, w=self.win_length, varnorm=self.var_norm, indices=idx)
      out[name] = x.astype("float32")
    return out


class Read3ColSAD(Extractor):
  """Parse 3-column (name, start, end) SAD label files into frame masks
  (reference :1613)."""

  def __init__(self, path: str, step_length: float = 0.010,
               output_name="sad"):
    super().__init__(output_name=(output_name,))
    self.step_length = float(step_length)
    self.table = {}
    with open(path) as f:
      for line in f:
        parts = line.split()
        if len(parts) >= 3:
          self.table.setdefault(parts[0], []).append(
              (float(parts[1]), float(parts[2])))

  def transform(self, X):
    feat = X if isinstance(X, dict) else {"raw": X}
    name = feat.get("name")
    n = None
    for key in ("energy", "mspec", "mfcc", "spec", "frames"):
      if key in feat:
        n = len(feat[key])
        break
    assert n is not None, "no framed feature to size the SAD mask"
    mask = np.zeros(n, bool)
    for start, end in self.table.get(name, ()):
      i0 = int(start / self.step_length)
      i1 = int(end / self.step_length)
      mask[i0:min(i1, n)] = True
    out = dict(feat)
    out[self.output_name[0]] = mask
    return out


class ApplyingSAD(Extractor):
  """Keep only speech frames (reference :1691)."""

  def __init__(self, input_name=("mspec", "mfcc"), sad_name: str = "sad"):
    super().__init__(input_name=input_name)
    self.sad_name = sad_name

  def transform(self, X):
    feat = X if isinstance(X, dict) else {"raw": X}
    sad = np.asarray(feat[self.sad_name]).astype(bool)
    out = dict(feat)
    for name in self.input_name:
      if name in feat and feat[name] is not None:
        x = feat[name]
        out[name] = x[sad[:len(x)]]
    return out


class BNFExtractor(Extractor):
  """Deep bottleneck features from a PyTorch network (the JAX package's
  ``BNFExtractor``, ``odin_tpu/preprocessing/speech.py:680-736``; reference
  ``speech.py:1012`` `_BNFExtractorBase` / :1084 / :1168).

  The reference's recipe: MVN from the speech frames' statistics -> stack
  ``2*context+1`` frames -> optionally drop the non-speech frames -> apply
  the network in minibatches of `batch_size` rows -> float32.  `network` is
  a ``torch.nn.Module`` (moved to `device` and put in eval mode) or a
  callable on tensors.  The forward runs on `device`, the card unless the
  caller asks for the CPU, under ``torch.inference_mode()`` with TF32 off,
  so that the card computes in fp32 as the CPU does.  The JAX package's
  ``(flax_module, params)`` form becomes a module through
  ``weights.from_jax_dense_stack``.  A pipeline holding this stage on the
  card cannot run in forked workers (``FeatureProcessor`` with ``ncpu >
  1`` refuses it).
  """

  def __init__(self, input_name: str,
               network: Union["torch.nn.Module", Callable],
               output_name: str = "bnf", sad_name: Optional[str] = "sad",
               remove_non_speech: bool = True, stack_context: int = 10,
               pre_mvn: bool = True, batch_size: int = 2048,
               device: Union[str, "torch.device"] = "cuda"):
    import torch
    from odin_tpu_torch.device import resolve_device
    names = (input_name, sad_name) if sad_name else (input_name,)
    super().__init__(input_name=names, output_name=(output_name,))
    self.sad_name = sad_name
    self.remove_non_speech = bool(remove_non_speech)
    self.stack_context = int(stack_context or 0)
    self.pre_mvn = bool(pre_mvn)
    self.batch_size = int(batch_size)
    if isinstance(network, tuple):
      raise TypeError("a (flax module, params) pair has no PyTorch "
                      "counterpart: build the network with "
                      "odin_tpu_torch.weights.from_jax_dense_stack(params)")
    if not callable(network):
      raise TypeError(f"network must be a torch.nn.Module or a callable on "
                      f"tensors, got {type(network).__name__}")
    self.device = resolve_device(device)
    if isinstance(network, torch.nn.Module):
      network = network.to(self.device).eval()
    self.network = network

  def _forward(self, x: np.ndarray) -> np.ndarray:
    import torch
    from odin_tpu_torch.ml.gmm_tmat import ieee_fp32_matmuls
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    if self.device.type == "cuda":
      t = t.pin_memory().to(self.device, non_blocking=True)
    with torch.inference_mode(), ieee_fp32_matmuls():
      return self.network(t).float().cpu().numpy()

  def _transform(self, inputs):
    X = np.asarray(inputs[0])
    sad = None
    if self.sad_name is not None:
      sad = np.asarray(inputs[1]).astype(bool)
      if len(sad) != len(X):
        raise ValueError(f"sad length {len(sad)} != frames {len(X)}")
    X_speech = X[sad] if sad is not None else X
    if self.pre_mvn:
      X = (X - X_speech.mean(0, keepdims=True)) / (
          X_speech.std(0, keepdims=True) + 1e-18)
    if self.stack_context > 0:
      X = S.stack_frames(X, frame_length=self.stack_context * 2 + 1,
                         step_length=1, keep_length=True)
    if self.remove_non_speech and sad is not None:
      X = X[sad]
    bs = self.batch_size
    out = [self._forward(X[s:s + bs]) for s in range(0, len(X), bs)]
    return np.concatenate(out, axis=0).astype("float32")


class AudioAugmentor(Extractor):
  """Waveform-augmentation stage (the reference's `AudioAugmentor` over
  ``preprocessing/audio/audio.py:8``): replaces the raw waveform with ONE
  randomly corrupted version per utterance (speed/pitch/gain/noise/shift
  via :func:`odin_tpu_torch.preprocessing.audio.augment_audio`).  Deterministic
  per utterance: the seed folds in the waveform checksum."""

  def __init__(self, allow_speedandpitch: bool = True,
               allow_pitch: bool = True, allow_speed: bool = True,
               allow_dyn: bool = True, allow_noise: bool = True,
               allow_timeshift: bool = True, seed: int = 8):
    super().__init__(input_name=("raw", "sr"), output_name=("raw",))
    self.kwargs = dict(allow_speedandpitch=allow_speedandpitch,
                       allow_pitch=allow_pitch, allow_speed=allow_speed,
                       allow_dyn=allow_dyn, allow_noise=allow_noise,
                       allow_timeshift=allow_timeshift)
    self.seed = int(seed)

  def _transform(self, X):
    from odin_tpu_torch.preprocessing.audio import augment_audio
    y, sr = X
    local = (self.seed + int(np.abs(np.asarray(y, np.float64)).sum() * 1e3)
             ) % (2 ** 31)
    return augment_audio(y, int(sr), n_augment=1, seed=local,
                         **self.kwargs)[1].astype(y.dtype)
