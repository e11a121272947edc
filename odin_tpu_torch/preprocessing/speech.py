"""Audio readers (host NumPy): a copy of the readers of
``odin_tpu/preprocessing/speech.py:34-240`` (``read_wave``,
``read_wave_raw``, ``save_wave``, ``_ulaw_expand``, ``read_pcm``,
``read_sphere``, ``read``), so that the port never imports the JAX package.
The extractor classes of that module are not ported yet.
"""
from __future__ import annotations

import io
import wave
from typing import Optional, Tuple

import numpy as np

__all__ = ["read_wave", "read_wave_raw", "save_wave", "read_sphere",
           "read_pcm", "read"]


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
