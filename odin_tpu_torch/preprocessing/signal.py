"""Host-side DSP bases (NumPy): the mel and DCT filterbanks and the window.

A copy of the few functions of ``odin_tpu/preprocessing/signal.py`` that the
feature path needs (``hz2mel`` :38, ``mel2hz`` :50, ``mel_filters`` :62,
``dct_filters`` :85, ``get_window`` :95), so that the port never imports the
JAX package.  Slaney mel scale, librosa conventions.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["hz2mel", "mel2hz", "mel_filters", "dct_filters", "get_window"]


def hz2mel(frequencies):
  f = np.atleast_1d(np.asarray(frequencies, dtype=np.float64))
  f_min, f_sp = 0.0, 200.0 / 3
  mels = (f - f_min) / f_sp
  min_log_hz = 1000.0
  min_log_mel = (min_log_hz - f_min) / f_sp
  logstep = np.log(6.4) / 27.0
  log_t = f >= min_log_hz
  mels[log_t] = min_log_mel + np.log(f[log_t] / min_log_hz) / logstep
  return mels


def mel2hz(mels):
  m = np.atleast_1d(np.asarray(mels, dtype=np.float64))
  f_min, f_sp = 0.0, 200.0 / 3
  freqs = f_min + f_sp * m
  min_log_hz = 1000.0
  min_log_mel = (min_log_hz - f_min) / f_sp
  logstep = np.log(6.4) / 27.0
  log_t = m >= min_log_mel
  freqs[log_t] = min_log_hz * np.exp(logstep * (m[log_t] - min_log_mel))
  return freqs


def mel_filters(sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0,
                fmax: Optional[float] = None) -> np.ndarray:
  """[n_mels, 1 + n_fft//2] Slaney triangular filterbank."""
  if fmax is None:
    fmax = float(sr) / 2
  n_mels = int(n_mels)
  weights = np.zeros((n_mels, int(1 + n_fft // 2)))
  fftfreqs = np.linspace(0, float(sr) / 2, int(1 + n_fft // 2), endpoint=True)
  min_mel = float(hz2mel(fmin)[0])
  max_mel = float(hz2mel(fmax)[0])
  mel_f = mel2hz(np.linspace(min_mel, max_mel, n_mels + 2))
  fdiff = np.diff(mel_f)
  ramps = np.subtract.outer(mel_f, fftfreqs)
  for i in range(n_mels):
    lower = -ramps[i] / fdiff[i]
    upper = ramps[i + 2] / fdiff[i + 1]
    weights[i] = np.maximum(0, np.minimum(lower, upper))
  enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
  weights *= enorm[:, np.newaxis]
  return weights


def dct_filters(n_filters: int, n_input: int) -> np.ndarray:
  """DCT type-III basis [n_filters, n_input]."""
  basis = np.empty((n_filters, n_input))
  basis[0, :] = 1.0 / np.sqrt(n_input)
  samples = np.arange(1, 2 * n_input, 2) * np.pi / (2.0 * n_input)
  for i in range(1, n_filters):
    basis[i, :] = np.cos(i * samples) * np.sqrt(2.0 / n_input)
  return basis


def get_window(window, frame_length: int, periodic: bool = True) -> np.ndarray:
  """scipy window lookup (a name, a (name, param) tuple, a callable or the
  window itself)."""
  if callable(window):
    return window(frame_length)
  if isinstance(window, (str, tuple)) or np.isscalar(window):
    from scipy import signal as sp_signal
    return sp_signal.get_window(window, frame_length, fftbins=periodic)
  window = np.asarray(window)
  if len(window) != frame_length:
    raise ValueError(f"window size mismatch: {len(window)} != {frame_length}")
  return window
