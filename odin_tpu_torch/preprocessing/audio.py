"""Waveform augmentation utilities (host NumPy): a copy of
``odin_tpu/preprocessing/audio.py``.

Reference: ``odin/preprocessing/audio/audio.py`` — `augment_audio`
(speed/pitch/dynamic-range/noise/time-shift corruptions used for training-
time augmentation) and `logscale_spec`.  The reference delegated pitch and
tempo to librosa; here `time_stretch` is a self-contained phase vocoder over
this package's `stft`/`istft` and `pitch_shift` composes it with the
polyphase `resample` — no librosa.

These run on host NumPy by design: augmentation happens per-utterance
before batching (the device pipeline consumes the already-augmented,
padded frame batches).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from odin_tpu_torch.preprocessing.signal import istft, resample, stft

__all__ = ["time_stretch", "pitch_shift", "augment_audio", "logscale_spec"]


def time_stretch(y: np.ndarray, rate: float, frame_length: int = 2048,
                 step_length: Optional[int] = None) -> np.ndarray:
  """Phase-vocoder tempo change without pitch change: ``rate > 1`` speeds
  up (shorter output).  Standard Flanagan/Laroche vocoder: magnitudes are
  linearly interpolated on the resampled frame grid while phases advance by
  the accumulated instantaneous frequency."""
  if rate <= 0:
    raise ValueError(f"rate must be > 0, got {rate}")
  y = np.asarray(y, np.float32)
  step = step_length or frame_length // 4
  D = stft(y, frame_length=frame_length, step_length=step, window="hann",
           n_fft=frame_length)
  T, F = D.shape
  # expected per-hop phase advance of each bin
  phi_advance = 2.0 * np.pi * step * np.arange(F) / frame_length
  steps = np.arange(0.0, T, rate)
  D_pad = np.concatenate([D, np.zeros((2, F), D.dtype)], axis=0)
  out = np.zeros((len(steps), F), np.complex128)
  phase = np.angle(D_pad[0])
  for i, s in enumerate(steps):
    j = int(s)
    frac = s - j
    mag = (1.0 - frac) * np.abs(D_pad[j]) + frac * np.abs(D_pad[j + 1])
    out[i] = mag * np.exp(1j * phase)
    dphi = np.angle(D_pad[j + 1]) - np.angle(D_pad[j]) - phi_advance
    dphi = dphi - 2.0 * np.pi * np.round(dphi / (2.0 * np.pi))
    phase = phase + phi_advance + dphi
  return istft(out, frame_length=frame_length, step_length=step,
               window="hann").astype(np.float32)


def pitch_shift(y: np.ndarray, sr: int, n_steps: float,
                bins_per_octave: int = 12, frame_length: int = 2048) -> np.ndarray:
  """Pitch shift by ``n_steps`` (in ``bins_per_octave`` units) at constant
  duration: time-stretch by ``2**(-n/bins)`` (longer for upward shifts)
  then resample the duration back — frequencies scale by ``2**(n/bins)``
  (the composition librosa uses, on this package's kernels)."""
  from fractions import Fraction
  del sr  # the shift is sample-rate-free; kept for reference API parity
  rate = 2.0 ** (-float(n_steps) / bins_per_octave)
  stretched = time_stretch(y, rate=rate, frame_length=frame_length)
  # shrink the length by `rate` (rational approximation for the polyphase)
  fr = Fraction(rate).limit_denominator(1000)
  shifted = resample(stretched, fr.denominator, fr.numerator)
  n = len(np.asarray(y))
  if len(shifted) < n:
    shifted = np.pad(shifted, (0, n - len(shifted)))
  return shifted[:n].astype(np.float32)


def augment_audio(y: np.ndarray,
                  sr: int,
                  n_augment: int = 0,
                  allow_speedandpitch: bool = True,
                  allow_pitch: bool = True,
                  allow_speed: bool = True,
                  allow_dyn: bool = True,
                  allow_noise: bool = True,
                  allow_timeshift: bool = True,
                  seed: Optional[int] = None) -> List[np.ndarray]:
  """Random waveform corruptions for augmentation (reference
  ``audio/audio.py:8``): returns ``[y, mod_1, ..., mod_n]`` where each mod
  applies a random subset of speed+pitch / pitch / speed / dynamic-range /
  noise / time-shift changes, with the reference's ranges (speed 0.9-1.1,
  pitch +-4 quarter-steps, gain 0.5-1.1, noise <=0.5% of peak, shift
  <=20%).  All outputs keep the input length.  Deterministic under `seed`
  (the reference used the global RandomState)."""
  rng = np.random.RandomState(seed)
  y = np.asarray(y, np.float32)
  length = y.shape[0]
  mods: List[np.ndarray] = [y]

  def on() -> bool:
    return bool(rng.rand() > 0.5)

  for _ in range(int(n_augment)):
    y_mod = y.copy()
    changed = 0
    while changed == 0:
      if allow_speedandpitch and on():
        # resample-in-place: changes speed AND pitch together
        length_change = rng.uniform(0.9, 1.1)
        tmp = np.interp(np.arange(0, length, 1.0 / length_change),
                        np.arange(length), y_mod)
        y_mod = np.zeros_like(y_mod)
        n = min(length, len(tmp))
        y_mod[:n] = tmp[:n]
        changed += 1
      if allow_pitch and on():
        n_steps = 4 * 2 * (rng.rand() - 0.5)  # +-4 quarter-steps
        y_mod = pitch_shift(y_mod, sr, n_steps, bins_per_octave=24,
                            frame_length=min(2048, length))
        changed += 1
      if allow_speed and on():
        rate = rng.uniform(0.9, 1.1)
        tmp = time_stretch(y_mod, rate, frame_length=min(2048, length))
        out = np.zeros_like(y_mod)
        n = min(length, len(tmp))
        out[:n] = tmp[:n]
        y_mod = out
        changed += 1
      if allow_dyn and on():
        y_mod = y_mod * rng.uniform(0.5, 1.1)
        changed += 1
      if allow_noise and on():
        noise_amp = 0.005 * rng.rand() * np.max(np.abs(y))
        y_mod = y_mod + noise_amp * rng.normal(size=length).astype(np.float32)
        changed += 1
      if allow_timeshift and on():
        start = int(length * 0.2 * 2 * (rng.rand() - 0.5))
        if start > 0:
          y_mod = np.pad(y_mod, (start, 0))[:length]
        elif start < 0:
          y_mod = np.pad(y_mod, (0, -start))[-length:]
        changed += 1
    mods.append(y_mod.astype(np.float32))
  return mods


def logscale_spec(spec: np.ndarray, sr: int = 44100, alpha: float = 1.0,
                  f0: float = 0.9, fmax: float = 1.0):
  """Piecewise-linear log-like frequency warping of a spectrogram
  (reference ``audio/audio.py:117``): bins below the knee ``f0`` are
  scaled by ``alpha``, bins above follow the complementary slope so the
  last bin maps to the last bin.  Returns ``(warped_spec, center_freqs)``.
  The reference's Python2 loop is replaced by a vectorized two-bin
  scatter."""
  spec = np.asarray(spec)
  spec = spec[:, :256] if spec.shape[1] > 256 else spec
  timebins, freqbins = spec.shape
  scale = np.linspace(0, 1, freqbins)
  scale = np.where(scale <= f0, scale * alpha,
                   (fmax - alpha * f0) / (fmax - f0) * (scale - f0) +
                   alpha * f0)
  scale *= (freqbins - 1) / max(scale)
  allfreqs = np.abs(np.fft.fftfreq(freqbins * 2, 1.0 / sr)[:freqbins + 1])

  newspec = np.zeros((timebins, freqbins), dtype=np.complex128)
  freqs = np.zeros(freqbins)
  totw = np.zeros(freqbins)
  # edge bins copied straight through (reference behavior)
  for i in (0, freqbins - 1):
    newspec[:, i] += spec[:, i]
    freqs[i] += allfreqs[i]
    totw[i] += 1.0
  inner = np.arange(1, freqbins - 1)
  j = np.floor(scale[inner]).astype(int)
  w_up = scale[inner] - j
  w_down = 1.0 - w_up
  np.add.at(newspec, (slice(None), j), w_down * spec[:, inner])
  np.add.at(newspec, (slice(None), np.minimum(j + 1, freqbins - 1)),
            w_up * spec[:, inner])
  np.add.at(freqs, j, w_down * allfreqs[inner])
  np.add.at(freqs, np.minimum(j + 1, freqbins - 1), w_up * allfreqs[inner])
  np.add.at(totw, j, w_down)
  np.add.at(totw, np.minimum(j + 1, freqbins - 1), w_up)
  nz = totw > 1e-6
  freqs[nz] /= totw[nz]
  return newspec, freqs
