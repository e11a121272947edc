"""Host DSP library (NumPy/SciPy): a copy of
``odin_tpu/preprocessing/signal.py``, so that the port never imports the JAX
package.

The functions are the JAX package's op for op (the same float order, so the
results are equal bit for bit): framing (`segment_axis`), the STFT with the
reference's window-sum scaling, Slaney mel filters, the DCT, `power2db`,
librosa-style `delta`, `mvn`/`wmvn`, `rastafilt`, `pre_emphasis`,
`shifted_deltas`, `smooth`, CQT, YIN and subharmonic-summation pitch,
loudness and the VAD helpers.

`vad_energy` fits the JAX package's 1-D diagonal ``GaussianMixture`` from
its given weights, means and precisions with scikit-learn's EM carried in
NumPy float64 (``preprocessing/_mixture.py``): the card's machine has no
scikit-learn.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
from scipy import signal as sp_signal

__all__ = [
    "hz2mel", "mel2hz", "mel_filters", "dct_filters", "get_window",
    "segment_axis", "stft", "istft", "get_energy", "power_spectrogram",
    "power2db", "db2power", "mels_spectrogram", "ceps_spectrogram",
    "pre_emphasis", "delta", "shifted_deltas", "mvn", "wmvn", "rastafilt",
    "smooth", "vad_energy", "vad_threshold", "pad_sequences", "griffin_lim",
    "shs_pitch", "loudness", "intensity",
]


# ---------------------------------------------------------------------------
# Mel / DCT bases (librosa-Slaney conventions, reference :489-811)
# ---------------------------------------------------------------------------
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
  """[n_mels, 1 + n_fft//2] Slaney triangular filterbank
  (reference :736-811)."""
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
  """DCT type-III basis [n_filters, n_input] (reference :683)."""
  basis = np.empty((n_filters, n_input))
  basis[0, :] = 1.0 / np.sqrt(n_input)
  samples = np.arange(1, 2 * n_input, 2) * np.pi / (2.0 * n_input)
  for i in range(1, n_filters):
    basis[i, :] = np.cos(i * samples) * np.sqrt(2.0 / n_input)
  return basis


def get_window(window, frame_length: int, periodic: bool = True) -> np.ndarray:
  """scipy window lookup (reference :811-835)."""
  if callable(window):
    return window(frame_length)
  if isinstance(window, (str, tuple)) or np.isscalar(window):
    return sp_signal.get_window(window, frame_length, fftbins=periodic)
  window = np.asarray(window)
  if len(window) != frame_length:
    raise ValueError(f"window size mismatch: {len(window)} != {frame_length}")
  return window


# ---------------------------------------------------------------------------
# Framing + STFT (reference :1296,1442)
# ---------------------------------------------------------------------------
def segment_axis(a: np.ndarray, frame_length: int = 2048,
                 step_length: int = 512, axis: int = 0, end: str = "cut",
                 pad_value: float = 0, pad_mode: str = "post") -> np.ndarray:
  """Chop an array into overlapping frames along `axis`
  (reference :1296-1360)."""
  if axis is None:
    a = np.ravel(a)
    axis = 0
  length = a.shape[axis]
  overlap = frame_length - step_length
  if overlap >= frame_length:
    raise ValueError("frames cannot overlap by more than 100%")
  if overlap < 0 or frame_length <= 0:
    raise ValueError("overlap must be nonnegative and length must be positive")
  if length < frame_length or (length - frame_length) % step_length:
    if length > frame_length:
      roundup = frame_length + (
          1 + (length - frame_length) // step_length) * step_length
      rounddown = frame_length + (
          (length - frame_length) // step_length) * step_length
    else:
      roundup = frame_length
      rounddown = 0
    assert rounddown < length < roundup
    if end == "cut":
      a = np.take(a, range(rounddown), axis=axis)
    elif end in ("pad", "wrap"):
      pad_width = [(0, 0)] * a.ndim
      extra = roundup - length
      if pad_mode == "post":
        pad_width[axis] = (0, extra)
      else:
        pad_width[axis] = (extra, 0)
      if end == "pad":
        a = np.pad(a, pad_width, mode="constant", constant_values=pad_value)
      else:
        a = np.pad(a, pad_width, mode="wrap")
    else:
      raise ValueError(f"unknown end mode '{end}'")
    length = a.shape[axis]
  if length == 0:
    raise ValueError("not enough data for even one frame")
  n_frames = 1 + (length - frame_length) // step_length
  # move target axis to front, frame, move back
  a = np.moveaxis(a, axis, 0)
  new_shape = (n_frames, frame_length) + a.shape[1:]
  new_strides = (step_length * a.strides[0], a.strides[0]) + a.strides[1:]
  out = np.lib.stride_tricks.as_strided(a, shape=new_shape,
                                        strides=new_strides)
  return np.moveaxis(out, 0, axis) if axis != 0 else out


def get_energy(frames: np.ndarray, log: bool = True) -> np.ndarray:
  """Frame-wise (log) energy [n_frames, 1] (reference :1421-1440)."""
  e = (frames ** 2).sum(axis=1)
  e = np.where(e == 0.0, np.finfo(np.float32).eps, e)
  if log:
    e = np.log(e)
  return np.expand_dims(e.astype("float32"), -1)


def stft(y: np.ndarray,
         frame_length: Optional[int] = None,
         step_length: Optional[int] = None,
         n_fft: Optional[int] = None,
         window: Union[str, np.ndarray, None] = "hann",
         scale: Optional[float] = None,
         padding: bool = False,
         energy: bool = False):
  """STFT with the reference's conventions (reference :1442-1564):
  frames start at ``t * step_length``; the matrix is scaled by
  ``sqrt(1 / sum(window)^2)``; optional centered padding of
  ``frame_length // 2``; returns [t, 1 + n_fft//2] complex."""
  y = np.asarray(y)
  if y.ndim == 2 and y.shape[1] > 2:
    frames, y = y, None
  else:
    frames = None
  if frame_length is None:
    if frames is None:
      raise ValueError("frame_length required when not passing frames")
    frame_length = frames.shape[1]
  frame_length = int(frame_length)
  step_length = int(step_length) if step_length is not None else frame_length // 4
  if n_fft is None:
    n_fft = int(2 ** np.ceil(np.log2(frame_length)))
  elif n_fft < frame_length:
    raise ValueError("n_fft must be >= frame_length")
  if frames is None:
    if padding:
      y = np.pad(y, int(frame_length // 2), mode="constant")
    shape = y.shape[:-1] + (y.shape[-1] - frame_length + 1, frame_length)
    strides = y.strides + (y.strides[-1],)
    frames = np.lib.stride_tricks.as_strided(y, shape=shape, strides=strides)
    frames = frames[::step_length]
  if window is not None:
    w = get_window(window, frame_length, periodic=True).reshape(1, -1)
    frames = w * frames
    scale = np.sqrt(1.0 / w.sum() ** 2) if scale is None else float(scale)
  else:
    scale = np.sqrt(1.0 / frame_length ** 2) if scale is None else float(scale)
  if energy:
    log_energy = get_energy(frames, log=True)
  S = np.fft.rfft(frames, n=n_fft, axis=-1)
  if scale is not None:
    S = S * scale
  if energy:
    return S, log_energy
  return S


def istft(S: np.ndarray, frame_length: int, step_length: Optional[int] = None,
          window: str = "hann", padding: bool = False) -> np.ndarray:
  """Inverse STFT by overlap-add (reference :1565)."""
  step_length = int(step_length) if step_length else frame_length // 4
  n_fft = 2 * (S.shape[1] - 1)
  w = get_window(window, frame_length, periodic=True)
  scale = np.sqrt(1.0 / w.sum() ** 2)
  frames = np.fft.irfft(S / scale, n=n_fft, axis=-1)[:, :frame_length]
  n = frame_length + step_length * (len(frames) - 1)
  y = np.zeros(n)
  norm = np.zeros(n)
  for i, f in enumerate(frames):
    s = i * step_length
    y[s:s + frame_length] += w * f
    norm[s:s + frame_length] += w ** 2
  y = y / np.maximum(norm, 1e-8)
  if padding:
    y = y[frame_length // 2:-(frame_length // 2) or None]
  return y


def griffin_lim(spec_mag: np.ndarray, frame_length: int,
                step_length: Optional[int] = None, n_iter: int = 30,
                window: str = "hann", seed: int = 1) -> np.ndarray:
  """Griffin-Lim phase reconstruction (reference `ispec`, :1838)."""
  rng = np.random.RandomState(seed)
  angles = np.exp(2j * np.pi * rng.rand(*spec_mag.shape))
  for _ in range(n_iter):
    y = istft(spec_mag * angles, frame_length, step_length, window)
    S = stft(y, frame_length, step_length, n_fft=2 * (spec_mag.shape[1] - 1),
             window=window)
    S = S[:spec_mag.shape[0]]
    angles = np.exp(1j * np.angle(S))
  return istft(spec_mag * angles, frame_length, step_length, window)


def ispec(spec: np.ndarray, frame_length: int,
          step_length: Optional[int] = None, window: str = "hann",
          nb_iter: int = 48, normalize: bool = True, db: bool = False,
          padding: bool = False,
          de_preemphasis: Optional[float] = 0.97) -> np.ndarray:
  """Invert a (power/dB) spectrogram back to a waveform with Griffin-Lim
  (reference :1838-1903)."""
  del padding  # frames are already centered by stft
  spec = np.asarray(spec, np.float64)
  if db:
    spec = db2power(spec)
  mag = np.sqrt(np.maximum(spec, 0.0))
  y = griffin_lim(mag, frame_length, step_length, n_iter=int(nb_iter),
                  window=window)
  if de_preemphasis is not None and de_preemphasis > 0:
    # inverse of pre_emphasis: y[t] += coeff * y[t-1].  The IIR pole at
    # `coeff` has DC gain 1/(1-coeff) (~33x) — trim the edge transient
    # below (reference trims y[1000:-1000], :1897) or it dominates.
    from scipy.signal import lfilter
    y = lfilter([1.0], [1.0, -float(de_preemphasis)], y)
  if normalize:
    trim = 1000 if len(y) > 4000 else 0  # reference :1897, short-signal guard
    y = y[trim:len(y) - trim] if trim else y
    y = (y - y.mean()) / (y.std() + 1e-8)
  return y.astype("float32")


# ---------------------------------------------------------------------------
# Spectrogram stack (reference :636,1650,1693)
# ---------------------------------------------------------------------------
def power_spectrogram(S: np.ndarray, power: float = 2.0) -> np.ndarray:
  """|S|^power (reference `PowerSpecExtractor`)."""
  return np.abs(S) ** power


def power2db(S: np.ndarray, ref=1.0, amin: float = 1e-10,
             top_db: Optional[float] = 80.0) -> np.ndarray:
  """10 log10(S / ref) with top_db clipping (reference :636-683)."""
  if amin <= 0:
    raise ValueError("amin must be strictly positive")
  magnitude = np.abs(S)
  ref_value = ref(magnitude) if callable(ref) else np.abs(ref)
  log_spec = 10.0 * np.log10(np.maximum(amin, magnitude))
  log_spec -= 10.0 * np.log10(np.maximum(amin, ref_value))
  if top_db is not None:
    if top_db < 0:
      raise ValueError("top_db must be non-negative")
    log_spec = np.maximum(log_spec, log_spec.max() - top_db)
  return log_spec


def db2power(S_db: np.ndarray, ref: float = 1.0) -> np.ndarray:
  return ref * np.power(10.0, 0.1 * S_db)


def mels_spectrogram(spec: np.ndarray, sr: int, n_mels: int,
                     fmin: float = 64, fmax: Optional[float] = None,
                     top_db: float = 80.0) -> np.ndarray:
  """Power spectrum -> log-mel dB (reference :1650-1693)."""
  n_fft = int(2 * (spec.shape[1] - 1))
  fmax = (sr // 2) if fmax is None else int(fmax)
  fmin = int(fmin)
  if fmin >= fmax:
    raise ValueError(f"fmin must < fmax, given {fmin} >= {fmax}")
  mel_basis = mel_filters(sr, n_fft=n_fft,
                          n_mels=24 if n_mels is None else int(n_mels),
                          fmin=fmin, fmax=fmax)
  mel_spec = (mel_basis @ spec.T).T
  return power2db(mel_spec, top_db=top_db)


def ceps_spectrogram(mspec: np.ndarray, n_ceps: int,
                     remove_first_coef: bool = True) -> np.ndarray:
  """log-mel -> MFCC via DCT (reference :1693-1720)."""
  if remove_first_coef:
    dct_basis = dct_filters(int(n_ceps) + 1, mspec.shape[1])
    return (dct_basis @ mspec.T)[1:, :].T
  dct_basis = dct_filters(int(n_ceps), mspec.shape[1])
  return (dct_basis @ mspec.T).T


def spectra(sr: int,
            frame_length: int,
            y: Optional[np.ndarray] = None,
            S: Optional[np.ndarray] = None,
            step_length: Optional[int] = None,
            n_fft: int = 512,
            window: Union[str, np.ndarray] = "hann",
            n_mels: Optional[int] = None,
            n_ceps: Optional[int] = None,
            fmin: float = 64,
            fmax: Optional[float] = None,
            top_db: float = 80.0,
            power: float = 2.0,
            log: bool = True,
            padding: bool = False) -> dict:
  """All-in-one spectra extraction (reference ``signal.py:1718-1834``):
  -> dict with 'spec' (log-power dB if `log`), 'energy' (log-energy when
  computed from `y`), 'mspec' (log-mel), 'mfcc' — composed from the same
  bit-exact kernels the extractor pipeline uses."""
  mel_spec = mfcc = log_energy = None
  if S is None:
    S, log_energy = stft(y, frame_length=frame_length,
                         step_length=step_length, n_fft=n_fft,
                         window=window, padding=padding, energy=True)
  power = int(power)
  fmax = (4000 if sr is None else sr // 2) if fmax is None else int(fmax)
  fmin = int(fmin)
  if fmin >= fmax:
    raise ValueError(f"fmin must < fmax, but fmin={fmin} and fmax={fmax}")
  spec = np.abs(S) if "complex" in str(S.dtype) else np.asarray(S)
  if power > 1:
    spec = np.power(spec, power)
  if n_mels is not None or n_ceps is not None:
    mel_spec = mels_spectrogram(spec, sr, n_mels, fmin=fmin, fmax=fmax,
                                top_db=top_db)
  if n_ceps is not None:
    mfcc = ceps_spectrogram(mel_spec, n_ceps)
  if log:
    spec = power2db(spec, top_db=top_db)
  return {
      "spec": spec.astype("float32"),
      "energy": log_energy,
      "mspec": None if mel_spec is None else mel_spec.astype("float32"),
      "mfcc": None if mfcc is None else mfcc.astype("float32"),
  }


# ---------------------------------------------------------------------------
# Feature post-processing (reference :853-1090)
# ---------------------------------------------------------------------------
def pre_emphasis(s: np.ndarray, coeff: float = 0.97) -> np.ndarray:
  """Reference :955."""
  s = np.asarray(s)
  if s.ndim == 1:
    return np.append(s[0], s[1:] - coeff * s[:-1])
  return s - np.c_[s[:, :1], s[:, :-1]] * coeff


def delta(data: np.ndarray, width: int = 9, order: int = 1, axis: int = 0):
  """librosa-style delta features (reference :1002-1067)."""
  data = np.atleast_1d(data)
  if width < 3 or width % 2 != 1:
    raise ValueError("width must be an odd integer >= 3")
  order = int(order)
  if order <= 0:
    raise ValueError("order must be a positive integer")
  half_length = 1 + int(width // 2)
  window = np.arange(half_length - 1.0, -half_length, -1.0)
  window /= np.sum(np.abs(window) ** 2)
  padding = [(0, 0)] * data.ndim
  padding[axis] = (int(width), int(width))
  delta_x = np.pad(data, padding, mode="edge")
  all_deltas = []
  for _ in range(order):
    delta_x = sp_signal.lfilter(window, 1, delta_x, axis=axis)
    all_deltas.append(delta_x)
  out = []
  for dx in all_deltas:
    idx = [slice(None)] * dx.ndim
    idx[axis] = slice(-half_length - data.shape[axis], -half_length)
    out.append(dx[tuple(idx)].astype("float32"))
  return out[0] if order == 1 else out


def shifted_deltas(x: np.ndarray, N: int = 7, d: int = 1, P: int = 3,
                   k: int = 7) -> np.ndarray:
  """Shifted delta coefficients for language ID (reference :1068-1090)."""
  x = x.T
  if d < 1:
    raise ValueError("d should be an integer >= 1")
  nobs = x.shape[1]
  x = x[:N]
  w = 2 * d + 1
  dx = delta(x, w, order=1, axis=-1)
  sdc = np.empty((k * N, nobs))
  sdc[:] = np.tile(dx[:, -1], k).reshape(k * N, 1)
  for ix in range(k):
    if ix * P > nobs:
      break
    sdc[ix * N:(ix + 1) * N, :nobs - ix * P] = dx[:, ix * P:nobs]
  return sdc.T


def _fnorm(x, x_stat, varnorm):
  mean = x_stat.mean(axis=0)
  if varnorm:
    std = x_stat.std(axis=0)
    return (x - mean) / np.maximum(std, 1e-20)
  return x - mean


def mvn(x: np.ndarray, varnorm: bool = True,
        indices: Optional[np.ndarray] = None) -> np.ndarray:
  """Mean-variance normalization over time (reference :853)."""
  x_stat = x[indices] if indices is not None else x
  return _fnorm(x, x_stat, varnorm)


def wmvn(x: np.ndarray, w: int = 301, varnorm: bool = True,
         indices: Optional[np.ndarray] = None) -> np.ndarray:
  """Windowed MVN (reference :878-925) — vectorized: the per-frame python
  loop becomes sliding-window mean/std via cumulative sums."""
  if w < 3 or (w & 1) != 1:
    raise ValueError("window length should be an odd integer >= 3")
  nobs, ndim = x.shape
  if nobs < w:
    return mvn(x, varnorm=varnorm, indices=indices)
  hlen = (w - 1) // 2
  y = np.empty_like(x, dtype=np.float64)
  if indices is None:
    c1 = np.cumsum(np.vstack([np.zeros((1, ndim)), x]), axis=0)
    c2 = np.cumsum(np.vstack([np.zeros((1, ndim)), x ** 2]), axis=0)
    starts = np.arange(0, nobs - w + 1)
    s1 = c1[starts + w] - c1[starts]  # window sums
    s2 = c2[starts + w] - c2[starts]
    mean = s1 / w
    var = np.maximum(s2 / w - mean ** 2, 0.0)
    std = np.sqrt(var)
    center = x[hlen:nobs - hlen]
    if varnorm:
      y[hlen:nobs - hlen] = (center - mean) / np.maximum(std, 1e-20)
    else:
      y[hlen:nobs - hlen] = center - mean
    # boundary rows use first/last full-window statistics
    y[:hlen] = _fnorm(x[:hlen], x[:w], varnorm)
    y[nobs - hlen:] = _fnorm(x[nobs - hlen:], x[nobs - w:], varnorm)
  else:
    indices = np.asarray(indices).astype(bool).ravel()
    for ix in range(hlen, nobs - hlen):
      sel = indices[ix - hlen:ix + hlen + 1]
      x_stat = x[ix - hlen:ix + hlen + 1][sel]
      if len(x_stat) == 0:
        x_stat = x[ix - hlen:ix + hlen + 1]
      y[ix] = _fnorm(x[ix:ix + 1], x_stat, varnorm)[0]
    y[:hlen] = _fnorm(x[:hlen], x[:w][indices[:w]] if indices[:w].any()
                      else x[:w], varnorm)
    y[nobs - hlen:] = _fnorm(x[nobs - hlen:],
                             x[nobs - w:][indices[nobs - w:]]
                             if indices[nobs - w:].any() else x[nobs - w:],
                             varnorm)
  return y.astype(x.dtype)


def rastafilt(x: np.ndarray) -> np.ndarray:
  """RASTA IIR filtering over time (reference :926-954, Dan Ellis)."""
  x = x.T
  ndim, nobs = x.shape
  numer = np.arange(-2, 3)
  numer = -numer / np.sum(numer * numer)
  denom = [1, -0.94]
  z = np.zeros((ndim, 4))
  zi = [0.0, 0.0, 0.0, 0.0]
  for ix in range(ndim):
    _, z[ix, :] = sp_signal.lfilter(numer, 1, x[ix, :4], zi=zi, axis=-1)
  y = np.zeros((ndim, nobs))
  for ix in range(ndim):
    y[ix, 4:] = sp_signal.lfilter(numer, denom, x[ix, 4:], zi=z[ix, :],
                                  axis=-1)[0]
  return y.T


def smooth(x: np.ndarray, win: int = 11, window: str = "hanning") -> np.ndarray:
  """Reflection-padded smoothing (reference :969-1002)."""
  if win < 3:
    return x
  windows = {"flat": lambda n: np.ones(n, "d"), "hanning": np.hanning,
             "hamming": np.hamming, "bartlett": np.bartlett,
             "blackman": np.blackman}
  if window not in windows:
    raise ValueError(f"window must be one of {sorted(windows)}")
  s = np.concatenate([2 * x[0] - x[win - 1::-1], x,
                      2 * x[-1] - x[-1:-win:-1]], axis=0)
  w = windows[window](win)
  y = np.convolve(w / w.sum(), s, mode="same")
  return y[win:-win + 1]


# ---------------------------------------------------------------------------
# Voice activity detection (reference :293-341)
# ---------------------------------------------------------------------------
_VAD_MODE = 2.0


def vad_energy(log_energy: np.ndarray, distrib_nb: int = 3,
               nb_train_it: int = 25) -> Tuple[np.ndarray, float]:
  """GMM on normalized log-energy; speech = above
  ``max_mean - mode * sqrt(var)`` threshold (reference :293-331).  The
  mixture starts from fixed weights, means and precisions, so no k-means
  seeding enters; a fit that fails retries with one component fewer."""
  from odin_tpu_torch.preprocessing._mixture import GaussianMixture
  log_energy = np.asarray(log_energy, np.float64)
  log_energy = (log_energy - np.mean(log_energy)) / np.std(log_energy)
  if log_energy.ndim == 1:
    log_energy = log_energy[:, np.newaxis]
  world = GaussianMixture(
      n_components=distrib_nb, max_iter=nb_train_it,
      weights_init=np.ones(distrib_nb) / distrib_nb,
      means_init=(-2 + 4.0 * np.arange(distrib_nb) /
                  (distrib_nb - 1))[:, np.newaxis],
      precisions_init=np.ones((distrib_nb, 1)))
  try:
    world.fit(log_energy)
  except (ValueError, IndexError):
    if distrib_nb - 1 >= 2:
      return vad_energy(log_energy, distrib_nb=distrib_nb - 1,
                        nb_train_it=nb_train_it)
    return np.zeros(shape=(log_energy.shape[0],)), 0
  threshold = world.means_.max() - _VAD_MODE * np.sqrt(
      1.0 / world.precisions_[world.means_.argmax(), 0])
  label = log_energy.ravel() > threshold
  return label, threshold


def vad_threshold(frames: np.ndarray, threshold: float = 35) -> np.ndarray:
  """Reference :333-341."""
  energies = 20 * np.log10(np.std(frames, axis=0) + np.finfo(float).eps)
  max_energy = np.max(energies)
  return (energies > max_energy - threshold) & (energies > -55)


def cqt_kernels(sr: int, fmin: float = 32.70, n_bins: int = 84,
                bins_per_octave: int = 12,
                window: str = "hann") -> Tuple[np.ndarray, int]:
  """Complex constant-Q kernel bank [n_bins, n_fft] + n_fft.

  Brown & Puckette's direct method: bin k has center frequency
  ``fmin 2^(k/b)`` and a windowed complex exponential of Q-dependent length;
  the CQT of a frame is then one (frames_fft @ conj(kernels_fft)) matmul —
  a dense product, versus the reference's librosa fallback.
  """
  Q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
  freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
  if freqs[-1] > sr / 2:
    raise ValueError("highest CQT bin exceeds Nyquist; reduce n_bins/fmin")
  lengths = np.ceil(Q * sr / freqs).astype(int)
  n_fft = int(2 ** np.ceil(np.log2(lengths.max())))
  kernels = np.zeros((n_bins, n_fft), np.complex128)
  for k in range(n_bins):
    L = lengths[k]
    w = get_window(window, L, periodic=False) / L
    t = np.arange(L)
    sig = w * np.exp(2j * np.pi * freqs[k] * t / sr)
    start = (n_fft - L) // 2  # center the kernel
    kernels[k, start:start + L] = sig
  return kernels, n_fft


def cqt(y: np.ndarray, sr: int, step_length: int, fmin: float = 32.70,
        n_bins: int = 84, bins_per_octave: int = 12,
        window: str = "hann") -> np.ndarray:
  """Constant-Q transform magnitude [n_frames, n_bins]
  (reference `CQTExtractor`, ``speech.py:932``, which delegated to an
  external implementation; here the direct kernel-matmul method)."""
  kernels, n_fft = cqt_kernels(sr, fmin, n_bins, bins_per_octave, window)
  y = np.asarray(y, np.float64)
  if y.ndim > 1:  # downmix like AudioReader (multichannel -> mono)
    y = y.mean(axis=-1)
  pad = n_fft // 2
  y = np.pad(y, pad, mode="reflect")
  frames = segment_axis(y, n_fft, step_length, end="pad")
  F = np.fft.fft(frames, axis=1)
  K = np.fft.fft(kernels, axis=1)
  # inner product in frequency domain: <frame, kernel> = ifft0(F * conj(K))
  out = (F @ K.conj().T) / n_fft
  return np.abs(out).astype("float32")


def stack_frames(X: np.ndarray, frame_length: int,
                 step_length: Optional[int] = None,
                 keep_length: bool = False) -> np.ndarray:
  """Stack consecutive feature frames into one vector, shifting by
  `step_length` (reference :1225)."""
  X = np.asarray(X)
  if step_length is None:
    step_length = frame_length // 2
  if keep_length:
    pad = frame_length // 2
    X = np.pad(X, ((pad, frame_length - pad - 1), (0, 0)), mode="edge")
    step_length = 1
  frames = segment_axis(X, frame_length, step_length, axis=0, end="cut")
  return frames.reshape(frames.shape[0], -1)


def resample(y: np.ndarray, sr_orig: int, sr_new: int, axis: int = 0,
             best_algorithm: bool = True) -> np.ndarray:
  """Polyphase resampling (reference :835)."""
  from math import gcd
  from scipy.signal import resample_poly
  g = gcd(int(sr_new), int(sr_orig))
  return resample_poly(y, int(sr_new) // g, int(sr_orig) // g,
                       axis=axis).astype(np.asarray(y).dtype)


def vad_split_audio(s: np.ndarray, sr: int, maximum_duration: float = 30,
                    minimum_duration: Optional[float] = None,
                    frame_length: int = 128, nb_mixtures: int = 3,
                    threshold: float = 0.6) -> list:
  """Split long audio at silent regions so every chunk is at most
  `maximum_duration` seconds (reference :341-430): energy-GMM VAD over
  coarse frames, cut at the quietest valid frame."""
  s = np.asarray(s)
  max_samples = int(maximum_duration * sr)
  min_samples = int((minimum_duration or maximum_duration / 4) * sr)
  if len(s) <= max_samples:
    return [s]
  frames = segment_axis(s, frame_length, frame_length, end="pad")
  energy = get_energy(frames, log=True).ravel()
  voiced, _ = vad_energy(energy, distrib_nb=nb_mixtures)
  chunks = []
  start = 0
  while len(s) - start > max_samples:
    lo = (start + min_samples) // frame_length
    hi = (start + max_samples) // frame_length
    window = energy[lo:hi]
    if len(window) == 0:
      cut = start + max_samples
    else:
      # prefer unvoiced frames; cut at the minimum-energy one
      unvoiced = np.where(~voiced[lo:hi])[0]
      idx = unvoiced[np.argmin(window[unvoiced])] if len(unvoiced) else \
          int(np.argmin(window))
      cut = (lo + idx) * frame_length
    chunks.append(s[start:cut])
    start = cut
  chunks.append(s[start:])
  return [c for c in chunks if len(c) > 0]


def pitch_track(y: np.ndarray, sr: int, step_length: int,
                frame_length: Optional[int] = None,
                fmin: float = 60.0, fmax: float = 260.0,
                threshold: float = 0.2, otype: str = "pitch",
                algorithm: str = "yin") -> np.ndarray:
  """Fundamental-frequency track via the YIN estimator.

  The reference shells out to pysptk's SWIPE/RAPT binaries
  (``signal.py:1904``); offline, natively, we implement YIN
  (de Cheveigne & Kawahara 2002): cumulative-mean-normalized difference
  over lags, absolute threshold, parabolic-free lag pick.  `otype`:
  'pitch' zeroes unvoiced frames, 'f0' keeps raw f0.
  """
  y = np.asarray(y, np.float64)
  tau_min = max(int(sr / fmax), 2)
  tau_max = int(sr / fmin)
  if frame_length is None:
    frame_length = 2 * tau_max
  span = frame_length + tau_max
  if len(y) < span:
    y = np.pad(y, (0, span - len(y)))
  frames = segment_axis(y, span, step_length, end="pad")  # (T, span)
  x0 = frames[:, :frame_length]
  # difference function d(tau) = sum_j (x_j - x_{j+tau})^2, vectorized
  taus = np.arange(tau_max + 1)
  # energy terms via cumulative sums
  csum2 = np.cumsum(frames ** 2, axis=1)
  e0 = csum2[:, frame_length - 1]
  e_tau = csum2[:, taus + frame_length - 1] - \
      np.concatenate([np.zeros((len(frames), 1)), csum2[:, taus[1:] - 1]], 1)
  # cross terms via FFT correlation
  n_fft = int(2 ** np.ceil(np.log2(span + frame_length)))
  F = np.fft.rfft(frames, n_fft, axis=1)
  X0 = np.fft.rfft(x0[:, ::-1], n_fft, axis=1)
  corr = np.fft.irfft(F * X0, n_fft, axis=1)[:, frame_length - 1:
                                             frame_length - 1 + tau_max]
  d = e0[:, None] + e_tau[:, :tau_max] - 2.0 * corr
  d = np.maximum(d, 0.0)
  # cumulative mean normalized difference
  cum = np.cumsum(d[:, 1:], axis=1)
  cmndf = np.ones_like(d)
  cmndf[:, 1:] = d[:, 1:] * np.arange(1, tau_max)[None, :] / \
      np.maximum(cum, 1e-12)
  # first lag below threshold in [tau_min, tau_max), else global argmin ...
  region = cmndf[:, tau_min:]
  below = region < threshold
  first = np.where(below.any(1), below.argmax(1), region.argmin(1)) + tau_min
  # ... refined to the local minimum of that valley (the crossing sits on
  # the valley's left edge and over-estimates f0 by ~10% otherwise)
  w = max(tau_min, 4)
  idx = np.minimum(first[:, None] + np.arange(w)[None, :], tau_max - 1)
  valley = np.take_along_axis(cmndf, idx, axis=1)
  best = first + valley.argmin(1)
  f0 = sr / best.astype(np.float64)
  voiced = region.min(1) < max(threshold, 0.5)
  out = f0 if otype == "f0" else np.where(voiced, f0, 0.0)
  return out.astype("float32")


def shs_pitch(y: np.ndarray, sr: int, step_length: int,
              frame_length: Optional[int] = None,
              fmin: float = 52.0, fmax: float = 620.0,
              n_harmonics: int = 15, compression: float = 0.84,
              bins_per_octave: int = 48, window: Union[str, tuple] = "hann",
              voicing_threshold: float = 0.7,
              otype: str = "pitch") -> Tuple[np.ndarray, np.ndarray]:
  """Subharmonic-summation pitch (Hermes 1988) + voicing probability.

  Native replacement for the reference's openSMILE ``prosodyShs.cfg``
  subprocess path (``odin/preprocessing/_opensmile.py:246-376``,
  SURVEY.md §2.0): amplitude spectrum resampled onto a log2-frequency
  grid, then the subharmonic sum ``H(f) = sum_n c^(n-1) A(n f)`` is a
  fixed set of grid shifts; the winning candidate in [fmin, fmax] is the
  pitch.  Voicing probability is the normalized autocorrelation at the
  winning period (the ACF comes free from the power spectrum already
  computed).  Returns ``(f0, voicing)`` per frame; `otype='pitch'`
  zeroes frames with ``voicing < voicing_threshold``.
  """
  y = np.asarray(y, np.float64)
  if frame_length is None:
    # >= 2 periods of the lowest candidate
    frame_length = int(np.ceil(2.0 * sr / fmin))
  if len(y) < frame_length:
    y = np.pad(y, (0, frame_length - len(y)))
  frames = segment_axis(y, frame_length, step_length, end="pad")
  w = get_window(window, frame_length)
  n_fft = int(2 ** np.ceil(np.log2(frame_length * 2)))
  spec = np.fft.rfft(frames * w, n_fft, axis=1)
  power = np.abs(spec) ** 2
  amp = np.sqrt(power)
  freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
  # log2-frequency grid covering [fmin, min(n_harmonics*fmax, Nyquist)]
  f_hi = min(sr / 2.0, n_harmonics * fmax)
  n_bins = int(np.ceil(np.log2(f_hi / fmin) * bins_per_octave)) + 1
  grid = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
  # vectorized linear interpolation of amp onto the grid
  hi = np.searchsorted(freqs, grid).clip(1, len(freqs) - 1)
  lo = hi - 1
  t = (grid - freqs[lo]) / np.maximum(freqs[hi] - freqs[lo], 1e-12)
  amp_g = amp[:, lo] * (1.0 - t) + amp[:, hi] * t  # (T, n_bins)
  # subharmonic summation: harmonic n lives log2(n) octaves up the grid
  n_cand = int(np.floor(np.log2(fmax / fmin) * bins_per_octave)) + 1
  n_cand = min(n_cand, n_bins)
  H = np.zeros((len(frames), n_cand))
  for n in range(1, n_harmonics + 1):
    shift = int(round(np.log2(n) * bins_per_octave))
    stop = min(n_cand, n_bins - shift)
    if stop <= 0:
      break
    H[:, :stop] += (compression ** (n - 1)) * amp_g[:, shift:shift + stop]
  best = H.argmax(axis=1)
  f0 = grid[best]
  # voicing: normalized ACF at the winning lag (Wiener-Khinchin)
  acf = np.fft.irfft(power, n_fft, axis=1)
  tau = np.clip(np.round(sr / f0), 1, n_fft // 2 - 1).astype(np.int64)
  r0 = acf[:, 0]
  voicing = np.clip(
      acf[np.arange(len(frames)), tau] / np.maximum(r0, 1e-12), 0.0, 1.0)
  voicing = np.where(r0 > 1e-12, voicing, 0.0)
  if otype == "pitch":
    f0 = np.where(voicing >= voicing_threshold, f0, 0.0)
  return f0.astype("float32"), voicing.astype("float32")


def loudness(y: np.ndarray, sr: int, frame_length: int, step_length: int,
             n_mels: int = 40, fmin: float = 20.0,
             fmax: Optional[float] = None, window: Union[str, tuple] = "hamm",
             ref_intensity: float = 1e-6) -> np.ndarray:
  """Narrow-band auditory loudness, one value per frame.

  Native replacement for openSMILE's "simple auditory band model"
  (``_opensmile.py:210-245``): mel-band intensities I_b from the windowed
  power spectrum, specific loudness ``(I_b / I0)^0.3`` (Zwicker power
  law; I0 = 1e-6 is openSMILE's 60 dB reference for signals in [-1, 1]),
  averaged over bands.
  """
  y = np.asarray(y, np.float64)
  if len(y) < frame_length:
    y = np.pad(y, (0, frame_length - len(y)))
  frames = segment_axis(y, frame_length, step_length, end="pad")
  w = get_window(window, frame_length)
  n_fft = int(2 ** np.ceil(np.log2(frame_length)))
  power = np.abs(np.fft.rfft(frames * w, n_fft, axis=1)) ** 2
  power /= (np.sum(w) ** 2 / 2.0)  # coherent-gain normalization
  fb = mel_filters(sr, n_fft, n_mels=n_mels, fmin=fmin, fmax=fmax)
  bands = power @ fb.T  # (T, n_mels)
  spec_loud = (np.maximum(bands, 0.0) / ref_intensity) ** 0.3
  return spec_loud.mean(axis=1).astype("float32")


def intensity(y: np.ndarray, sr: int, frame_length: int,
              step_length: int) -> np.ndarray:
  """Frame loudness ``L = (I / I0)^0.3`` with I = mean of squared
  Hamming-windowed samples, I0 = 1e-6 (openSMILE ``cIntensity``
  semantics, ``_opensmile.py:276-284`` docstring)."""
  y = np.asarray(y, np.float64)
  if len(y) < frame_length:
    y = np.pad(y, (0, frame_length - len(y)))
  frames = segment_axis(y, frame_length, step_length, end="pad")
  w = get_window("hamm", frame_length)
  I = np.mean((frames * w) ** 2, axis=1)
  return ((I / 1e-6) ** 0.3).astype("float32")


def pad_sequences(sequences, maxlen: Optional[int] = None,
                  dtype: str = "float32", padding: str = "pre",
                  truncating: str = "pre", value: float = 0.0) -> np.ndarray:
  """Pad a list of sequences to one 2-D array (reference :1157)."""
  lengths = [len(s) for s in sequences]
  if maxlen is None:
    maxlen = max(lengths)
  sample = np.asarray(sequences[0])
  trailing = sample.shape[1:]
  out = np.full((len(sequences), maxlen) + trailing, value, dtype=dtype)
  for i, s in enumerate(sequences):
    s = np.asarray(s)
    if len(s) == 0:
      continue
    if truncating == "pre":
      trunc = s[-maxlen:]
    else:
      trunc = s[:maxlen]
    if padding == "post":
      out[i, :len(trunc)] = trunc
    else:
      out[i, -len(trunc):] = trunc
  return out


def set_vad_mode(mode: float) -> None:
  """VAD sensitivity 1.0-2.4 — higher keeps more high-energy frames
  (reference :280; scales the GMM-threshold margin in `vad_energy`)."""
  global _VAD_MODE
  if isinstance(mode, (int, float)):
    _VAD_MODE = float(min(max(mode, 1.0), 2.4))


def mel_frequencies(n_mels: int = 128, fmin: float = 0.0,
                    fmax: float = 11025.0) -> np.ndarray:
  """Center frequencies of mel bands (reference :570)."""
  return mel2hz(np.linspace(float(np.asarray(hz2mel(fmin)).ravel()[0]),
                            float(np.asarray(hz2mel(fmax)).ravel()[0]),
                            int(n_mels)))


def pad_center(data: np.ndarray, size: int, axis: int = -1,
               **kwargs) -> np.ndarray:
  """Center `data` in a length-`size` axis by symmetric padding
  (librosa-style helper the reference re-exports)."""
  n = data.shape[axis]
  lpad = int((size - n) // 2)
  if lpad < 0:
    raise ValueError(f"target size {size} < input size {n}")
  lengths = [(0, 0)] * data.ndim
  lengths[axis] = (lpad, int(size - n - lpad))
  return np.pad(data, lengths, **kwargs)


def loudness2intensity(loudness: np.ndarray) -> np.ndarray:
  """openSMILE loudness -> intensity at the 60 dB standard
  (reference :483)."""
  loudness = np.asarray(loudness)
  if loudness.ndim == 2:
    loudness = loudness[:, 0]
  return loudness * 60.0


def anything2wav(inpath: str, outpath: Optional[str] = None,
                 channel: Optional[int] = None,
                 sample_rate: Optional[int] = None) -> np.ndarray:
  """Convert any audio container to wav via sox/ffmpeg when installed
  (reference :47 shelled to sox with per-dataset recipes).  This
  environment bundles neither binary, so the function is tool-gated; wav/
  sphere/pcm inputs never need it (`speech.read` decodes them natively)."""
  import shutil
  import subprocess
  tool = shutil.which("sox") or shutil.which("ffmpeg")
  if tool is None:
    raise RuntimeError(
        "anything2wav requires sox or ffmpeg on PATH (neither is bundled); "
        "wav / NIST sphere / raw PCM are read natively by "
        "odin_tpu_torch.preprocessing.speech.read")
  outpath = outpath or (os.path.splitext(inpath)[0] + ".converted.wav")
  if os.path.basename(tool) == "sox":
    cmd = [tool, inpath]
    if sample_rate:
      cmd += ["-r", str(int(sample_rate))]
    cmd += [outpath]
    if channel is not None:
      cmd += ["remix", str(int(channel) + 1)]
  else:
    cmd = [tool, "-y", "-i", inpath]
    if sample_rate:
      cmd += ["-ar", str(int(sample_rate))]
    if channel is not None:
      cmd += ["-af", f"pan=mono|c0=c{int(channel)}"]
    cmd += [outpath]
  subprocess.run(cmd, check=True, capture_output=True)
  from odin_tpu_torch.preprocessing.speech import read
  return read(outpath)


__all__ += ["set_vad_mode", "mel_frequencies", "pad_center",
            "loudness2intensity", "anything2wav"]
