"""Fused, batched speech features on padded batches (PyTorch port of
``odin_tpu/ops/features.py:41-255``).

  pre-emphasis -> framing -> window -> [K1: DFT -> power -> mel -> log]
  -> top-dB -> DCT (MFCC) -> deltas -> masked CMVN -> energy VAD

The log-mel core goes through the K1 wrapper (``ops/logmel.py``) by default
(``use_pallas=True``, the JAX package's name for its kernel branch): the
hand-written CUDA kernel on the card, its plain PyTorch version on the CPU.
``use_pallas=False`` takes the JAX package's default branch, the plain
matmul DFT, which also returns the power spectrum ``spec``.
All functions are mask-aware (padded frames are excluded from the top-dB
reference, CMVN and VAD statistics).

The tf.signal-compatible path (``TFCompatConfig``, ``tf_mel_matrix``,
``tf_signal_features``, ``odin_tpu/ops/features.py:261-409``) computes its
DFT with plain fp32 products, as the JAX package does outside any kernel.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from odin_tpu_torch.device import resolve_device
from odin_tpu_torch.ops.logmel import logmel, power_spectrum, untraced
from odin_tpu_torch.preprocessing import signal as np_signal

__all__ = ["FeatureConfig", "dft_bases", "frame_signal", "speech_features",
           "ulaw_expand_device", "TFCompatConfig", "tf_mel_matrix",
           "tf_signal_features"]


class FeatureConfig:
  """Static configuration of the fused feature pipeline."""

  def __init__(self,
               sr: int = 16000,
               frame_length: int = 400,
               step_length: int = 160,
               n_fft: int = 512,
               window: str = "hann",
               n_mels: int = 40,
               n_ceps: int = 20,
               fmin: float = 64.0,
               fmax: Optional[float] = None,
               top_db: float = 80.0,
               preemphasis: float = 0.97,
               remove_first_coef: bool = True,
               delta_width: int = 9,
               cmvn: bool = True):
    self.sr = int(sr)
    self.frame_length = int(frame_length)
    self.step_length = int(step_length)
    self.n_fft = int(n_fft)
    self.window = window
    self.n_mels = int(n_mels)
    self.n_ceps = int(n_ceps)
    self.fmin = float(fmin)
    self.fmax = float(fmax) if fmax is not None else float(sr) / 2
    self.top_db = float(top_db)
    self.preemphasis = float(preemphasis)
    self.remove_first_coef = bool(remove_first_coef)
    self.delta_width = int(delta_width)
    self.cmvn = bool(cmvn)
    self._bases: Dict[torch.device, Dict[str, torch.Tensor]] = {}

  @functools.cached_property
  def window_fn(self) -> np.ndarray:
    return np_signal.get_window(self.window, self.frame_length,
                                periodic=True).astype(np.float32)

  @functools.cached_property
  def scale(self) -> float:
    return float(np.sqrt(1.0 / self.window_fn.sum() ** 2))

  @functools.cached_property
  def mel_basis(self) -> np.ndarray:
    return np_signal.mel_filters(self.sr, self.n_fft, self.n_mels,
                                 self.fmin, self.fmax).astype(np.float32)

  @functools.cached_property
  def dct_basis(self) -> np.ndarray:
    n = self.n_ceps + 1 if self.remove_first_coef else self.n_ceps
    return np_signal.dct_filters(n, self.n_mels).astype(np.float32)

  def n_frames(self, n_samples: int) -> int:
    return 1 + (n_samples - self.frame_length) // self.step_length

  def device_bases(self, device: Union[str, torch.device]
                   ) -> Dict[str, torch.Tensor]:
    """The window, DFT, mel and DCT bases as fp32 tensors on `device`, built
    once per device: ``window`` (L,), ``cos``/``sin`` (L, n_freqs),
    ``mel_t`` (n_freqs, n_mels), ``dct_t`` (n_mels, n_dct)."""
    device = torch.device(device)
    if device not in self._bases:
      cos_b, sin_b = dft_bases(self.frame_length, self.n_fft)
      arrays = dict(window=self.window_fn, cos=cos_b, sin=sin_b,
                    mel_t=self.mel_basis.T, dct_t=self.dct_basis.T)
      # under torch.export the bases are the program's constants, never
      # the tracer's fake tensors, which the cache would keep after it
      with untraced():
        self._bases[device] = {
            k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
                device) for k, v in arrays.items()}
    return self._bases[device]


def dft_bases(frame_length: int, n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
  """Real-DFT cos/sin bases [frame_length, n_fft//2+1] so that
  rfft(x, n_fft) == x@cos - i * x@sin for x of length frame_length."""
  n_freqs = n_fft // 2 + 1
  t = np.arange(frame_length)[:, None]
  k = np.arange(n_freqs)[None, :]
  angle = 2.0 * np.pi * t * k / n_fft
  return (np.cos(angle).astype(np.float32),
          -np.sin(angle).astype(np.float32))


def frame_signal(y: torch.Tensor, frame_length: int,
                 step_length: int) -> torch.Tensor:
  """(B, T) -> (B, n_frames, frame_length), a strided view of `y`."""
  return y.unfold(-1, frame_length, step_length)


def _preemphasis(y: torch.Tensor, coeff: float) -> torch.Tensor:
  return torch.cat([y[..., :1], y[..., 1:] - coeff * y[..., :-1]], dim=-1)


def _delta_filter(width: int) -> np.ndarray:
  half = 1 + width // 2
  w = np.arange(half - 1.0, -half, -1.0)
  return (w / np.sum(np.abs(w) ** 2)).astype(np.float32)


def _batch_delta(x: torch.Tensor, width: int) -> torch.Tensor:
  """librosa-delta over the time axis of (B, T, F): the causal FIR
  ``lfilter(w, 1, edge_padded)`` trimmed at offset ``2·width − half``,
  written as a sum of shifted slices so that it stays in fp32 on the card
  (a cuDNN convolution would round through TF32)."""
  w = _delta_filter(width)
  half = 1 + width // 2
  T = x.shape[1]
  xp = torch.cat([x[:, :1].expand(-1, width, -1), x,
                  x[:, -1:].expand(-1, width, -1)], dim=1)
  start = 2 * width - half
  out = torch.zeros_like(x)
  for k, wk in enumerate(w):
    out = out + float(wk) * xp[:, start - k:start - k + T]
  return out


def ulaw_expand_device(u: torch.Tensor) -> torch.Tensor:
  """ITU-T G.711 mu-law expansion (uint8 codewords -> float32 in [-1, 1)),
  bit-exact with the host expansion."""
  u = torch.bitwise_not(u.to(torch.uint8)).to(torch.int32)
  sign = u & 0x80
  exponent = (u >> 4) & 0x07
  mantissa = u & 0x0F
  magnitude = (((mantissa << 3) + 0x84) << exponent) - 0x84
  pcm = torch.where(sign != 0, -magnitude, magnitude)
  return pcm.to(torch.float32) * (1.0 / 32768.0)


def speech_features(y, config: FeatureConfig, lengths=None,
                    device: Union[str, torch.device] = "cuda",
                    use_pallas: bool = True) -> Dict[str, torch.Tensor]:
  """Fused pipeline on a padded batch, on `device`.

  Args:
    y: (B, T) or (T,) audio, zero-padded to a common length T, as a numpy
      array or tensor: float32 in [-1, 1]; int16 raw PCM (scaled on the
      device); or uint8 G.711 mu-law codewords (expanded on the device).
    lengths: (B,) valid sample counts (defaults to the full length).
    device: where the pipeline runs; 'cpu' runs K1's plain version.
    use_pallas: True runs the log-mel core through K1 (the kernel on the
      card), whose power spectrum never leaves it; False runs the plain
      matmul DFT, power and mel products, as the JAX package's default
      branch does, and returns the power spectrum as 'spec'.

  Returns a dict of tensors on `device`: 'mspec' (log-mel dB, top-dB
  clipped), 'mfcc', 'energy' (log), 'frame_mask', 'vad' (energy threshold),
  with the config's defaults 'mspec_cmvn', 'mfcc_cmvn' and 'mfcc_delta',
  and with ``use_pallas=False`` 'spec' (power, (B, n_frames, n_freqs)).
  """
  device = resolve_device(device)
  y = torch.as_tensor(y).to(device)
  if y.ndim == 1:
    y = y[None]
  if y.dtype == torch.int16:
    y = y.to(torch.float32) * (1.0 / 32768.0)
  elif y.dtype == torch.uint8:
    y = ulaw_expand_device(y)
  B, T = y.shape
  n_frames = config.n_frames(T)
  if lengths is None:
    lengths = torch.full((B,), T, dtype=torch.int64, device=device)
  else:
    lengths = torch.as_tensor(lengths).to(device=device, dtype=torch.int64)
  frame_ends = (torch.arange(n_frames, device=device) * config.step_length +
                config.frame_length)
  mask = frame_ends[None, :] <= lengths[:, None]  # (B, n_frames)

  bases = config.device_bases(device)
  y = _preemphasis(y.to(torch.float32), config.preemphasis)
  frames_w = frame_signal(y, config.frame_length,
                          config.step_length) * bases["window"]
  energy = torch.sum(frames_w * frames_w, dim=-1)
  energy = torch.log(torch.clamp(energy, min=float(np.finfo(np.float32).eps)))
  if use_pallas:
    mspec_raw = logmel(frames_w, config)  # 10log10 mel power, unclipped
    spec = None
  else:
    spec = power_spectrum(frames_w, bases["cos"], bases["sin"],
                          config.scale ** 2)
    mel = torch.matmul(spec, bases["mel_t"])
    mspec_raw = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))

  # top_db clipping with the per-utterance max over VALID frames
  masked = torch.where(mask[..., None], mspec_raw,
                       torch.full((), -1e30, device=device))
  ref_max = torch.amax(masked, dim=(-2, -1), keepdim=True)
  mspec = torch.maximum(mspec_raw, ref_max - config.top_db)

  mfcc = torch.matmul(mspec, bases["dct_t"])
  if config.remove_first_coef:
    mfcc = mfcc[..., 1:]

  # energy-threshold VAD over the valid frames
  e_valid = torch.where(mask, energy, torch.full((), float("nan"),
                                                 device=device))
  e_mean = torch.nanmean(e_valid, dim=1, keepdim=True)
  e_std = torch.sqrt(torch.nanmean((e_valid - e_mean) ** 2, dim=1,
                                   keepdim=True))
  vad = (energy > (e_mean - 0.5 * e_std)) & mask

  out = dict(mspec=mspec, mfcc=mfcc, energy=energy[..., None],
             frame_mask=mask, vad=vad)
  if spec is not None:
    out["spec"] = spec
  if config.cmvn:
    m = mask[..., None].to(mspec.dtype)
    denom = torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1.0)
    for key in ("mspec", "mfcc"):
      f = out[key]
      mu = torch.sum(f * m, dim=1, keepdim=True) / denom
      var = torch.sum((f - mu) ** 2 * m, dim=1, keepdim=True) / denom
      out[key + "_cmvn"] = (f - mu) / torch.clamp(torch.sqrt(var), min=1e-20)
  if config.delta_width:
    out["mfcc_delta"] = _batch_delta(out["mfcc"], config.delta_width)
  return out


# ---------------------------------------------------------------------------
# tf.signal-compatible path
# ---------------------------------------------------------------------------
class TFCompatConfig:
  """Configuration of the tf.signal semantics of the original
  ``AudioFeatureLoader``: periodic Hann window, no pre-emphasis or
  centering, fft_length the next power of 2 of frame_length, HTK mel scale
  (``tf.signal.linear_to_mel_weight_matrix``), dB with a per-utterance
  top_DB floor, MFCC by the orthogonally scaled DCT-II of
  ``tf.signal.mfccs_from_log_mel_spectrograms``.  A numeric path distinct
  from ``FeatureConfig`` (Slaney mel, pre-emphasis)."""

  def __init__(self,
               frame_length: int = 256,
               frame_step: int = 80,
               fft_length: Optional[int] = None,
               sample_rate: int = 8000,
               power: float = 2.0,
               top_DB: Optional[float] = 80.0,
               num_mel_bins: int = 20,
               num_cepstral: Optional[int] = None,
               log_mels: bool = False,
               lower_edge_hertz: float = 125.0,
               upper_edge_hertz: float = 3800.0):
    self.frame_length = int(frame_length)
    self.frame_step = int(frame_step)
    if fft_length is None:
      fft_length = frame_length
    # the smallest power of 2 enclosing frame_length
    self.fft_length = 2 ** int(np.ceil(np.log2(fft_length)))
    self.sample_rate = int(sample_rate)
    self.power = float(power)
    self.top_DB = None if top_DB is None else float(top_DB)
    self.num_mel_bins = int(num_mel_bins)
    self.num_cepstral = num_cepstral
    self.log_mels = bool(log_mels)
    self.lower_edge_hertz = float(lower_edge_hertz)
    self.upper_edge_hertz = float(upper_edge_hertz)

  @functools.cached_property
  def window_fn(self) -> np.ndarray:
    # tf.signal.hann_window: periodic by default
    n = self.frame_length
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)) \
        .astype(np.float32)

  @functools.cached_property
  def mel_weight(self) -> np.ndarray:
    return tf_mel_matrix(self.num_mel_bins, self.fft_length // 2 + 1,
                         self.sample_rate, self.lower_edge_hertz,
                         self.upper_edge_hertz)

  @functools.cached_property
  def mfcc_basis(self) -> np.ndarray:
    """`mfccs_from_log_mel_spectrograms`: the unnormalized DCT-II scaled by
    1/sqrt(2*num_mel_bins), as one basis [num_mel_bins, n_out]."""
    N = self.num_mel_bins
    n = np.arange(N)[:, None]
    k = np.arange(N)[None, :]
    basis = 2.0 * np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * N))
    return (basis / np.sqrt(2.0 * N)).astype(np.float32)

  def n_frames(self, n_samples: int) -> int:
    # tf.signal.stft pad_end=False
    return 1 + (n_samples - self.frame_length) // self.frame_step


def _hertz_to_mel_htk(f):
  return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def tf_mel_matrix(num_mel_bins: int, num_spectrogram_bins: int,
                  sample_rate: float, lower_edge_hertz: float,
                  upper_edge_hertz: float) -> np.ndarray:
  """NumPy mirror of `tf.signal.linear_to_mel_weight_matrix` (HTK mel scale,
  first `bands_to_zero=1` spectrogram bin zeroed); shape
  [num_spectrogram_bins, num_mel_bins]."""
  bands_to_zero = 1
  nyquist = sample_rate / 2.0
  linear_freqs = np.linspace(0.0, nyquist,
                             num_spectrogram_bins)[bands_to_zero:]
  spec_mel = _hertz_to_mel_htk(linear_freqs)[:, None]
  edges = np.linspace(_hertz_to_mel_htk(lower_edge_hertz),
                      _hertz_to_mel_htk(upper_edge_hertz),
                      num_mel_bins + 2)
  lower, center, upper = edges[:-2][None, :], edges[1:-1][None, :], \
      edges[2:][None, :]
  lower_slopes = (spec_mel - lower) / (center - lower)
  upper_slopes = (upper - spec_mel) / (upper - center)
  w = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))
  return np.pad(w, [[bands_to_zero, 0], [0, 0]]).astype(np.float32)


def tf_signal_features(y, config: TFCompatConfig, lengths=None,
                       device: Union[str, torch.device] = "cuda"
                       ) -> Dict[str, torch.Tensor]:
  """Batched tf.signal features on `device`: (B, T) or (T,) float audio
  (numpy or tensor) with (B,) valid lengths.

  Returns a dict of tensors: 'stft_re'/'stft_im', 'spec' (dB
  magnitude^power), 'mels' (dB or log mel), 'mfcc', 'frame_mask'.  The
  per-utterance top_DB floor reads only the valid frames."""
  device = resolve_device(device)
  y = torch.as_tensor(y).to(device)
  if y.ndim == 1:
    y = y[None]
  y = y.to(torch.float32)
  B, T = y.shape
  n_frames = config.n_frames(T)
  if lengths is None:
    lengths = torch.full((B,), T, dtype=torch.int64, device=device)
  else:
    lengths = torch.as_tensor(lengths).to(device=device, dtype=torch.int64)
  frame_ends = (torch.arange(n_frames, device=device) * config.frame_step +
                config.frame_length)
  mask = frame_ends[None, :] <= lengths[:, None]

  as_tensor = lambda a: torch.from_numpy(
      np.ascontiguousarray(a, np.float32)).to(device)
  frames = frame_signal(y, config.frame_length, config.frame_step)
  frames = frames * as_tensor(config.window_fn)
  cos_b, sin_b = dft_bases(config.frame_length, config.fft_length)
  re = torch.matmul(frames, as_tensor(cos_b))
  im = torch.matmul(frames, as_tensor(sin_b))
  mag = torch.sqrt(re * re + im * im)
  if config.power > 1.0:
    mag = mag ** config.power

  def amplitude_to_db(s):
    # the per-utterance max floor over the valid frames
    multiplier = 10.0 if config.power == 2.0 else 20.0
    s_db = multiplier * (torch.log(torch.clamp(s, min=1e-10)) /
                         float(np.log(10.0)))
    if config.top_DB is not None:
      masked = torch.where(mask[..., None], s_db,
                           torch.full((), -1e30, device=device))
      ref = torch.amax(masked, dim=(-2, -1), keepdim=True)
      s_db = torch.maximum(s_db, ref - config.top_DB)
    return s_db

  mel = torch.matmul(mag, as_tensor(config.mel_weight))
  if config.log_mels:
    mels = torch.log(mel + 1e-6)
  else:
    mels = amplitude_to_db(mel)
  mfcc = torch.matmul(mels, as_tensor(config.mfcc_basis))
  if config.num_cepstral is not None:
    mfcc = mfcc[..., :int(config.num_cepstral)]
  return dict(stft_re=re, stft_im=im, spec=amplitude_to_db(mag), mels=mels,
              mfcc=mfcc, frame_mask=mask)
