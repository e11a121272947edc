"""K1: fused window-DFT-power-mel-log, two hand-written CUDA kernels.

``logmel`` takes windowed frames and returns ``10·log10(max(mel power,
1e-10))``, unclipped (top-dB applies outside with the per-utterance max).
Both kernels replace ``_logmel_kernel`` (``odin_tpu/ops/pallas_features.py:
32-39``); the configuration alone picks one (``kernel_route``):

* ``csrc/logmel_fft.cu``, an fp32 real FFT in shared memory, where n_fft is
  a power of two from 16 to 8192 (every config of the repo: the default is
  512);
* ``csrc/logmel.cu``, the dense real DFT, for every other n_fft.

On a CUDA tensor ``logmel`` launches the chosen kernel and raises if the
launch fails; there is no fallback and no retry.  On a CPU tensor it runs
``logmel_reference``, the plain PyTorch version of the same function.  Each
kernel's bound on the card and its design are noted in its CUDA source.
"""
from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, List, Tuple

import numpy as np
import torch

from odin_tpu_torch import _build

if TYPE_CHECKING:
  from odin_tpu_torch.ops.features import FeatureConfig

__all__ = ["fft_plan", "fft_twiddles", "harmonic_frames", "kernel_route",
           "logmel", "logmel_reference", "power_spectrum"]

# the dense kernel's constants (csrc/logmel.cu); `_library` checks them
CHUNK = 8  # kChunk: sample rows per staged chunk of the bases
MAX_FREQS = 288  # kMaxFreqs: bins per group of the bases
TILE_FRAMES = 32  # kTileFrames: frames per block
# the FFT kernel's range of n_fft, 2^4 .. 2^13 (csrc/logmel_fft.cu);
# `_fft_library` checks it
FFT_LOG2_RANGE = (4, 13)


def power_spectrum(frames: torch.Tensor, cos_b: torch.Tensor,
                   sin_b: torch.Tensor, scale_sq: float) -> torch.Tensor:
  """The scaled power of the real DFT by matmuls: (..., frame_length) ->
  (..., n_freqs), fp32."""
  re = torch.matmul(frames, cos_b)
  im = torch.matmul(frames, sin_b)
  return (re * re + im * im) * scale_sq


def logmel_reference(frames: torch.Tensor, cos_b: torch.Tensor,
                     sin_b: torch.Tensor, mel_t: torch.Tensor,
                     scale_sq: float) -> torch.Tensor:
  """Plain PyTorch K1: (..., frame_length) -> (..., n_mels), fp32."""
  mel = torch.matmul(power_spectrum(frames, cos_b, sin_b, scale_sq), mel_t)
  return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))


def kernel_route(n_fft: int) -> str:
  """The K1 kernel that takes a config: ``"fft"`` where n_fft is a power of
  two in the FFT kernel's range, else ``"dense"``.  The FFT kernel pads or
  folds a frame of any length to n_fft samples, as the dense bases do, so
  the frame length does not enter the choice."""
  lo, hi = FFT_LOG2_RANGE
  n_fft = int(n_fft)
  if n_fft > 0 and n_fft & (n_fft - 1) == 0 and 2 ** lo <= n_fft <= 2 ** hi:
    return "fft"
  return "dense"


def harmonic_frames(n_frames: int, config: "FeatureConfig", seed: int,
                    device) -> torch.Tensor:
  """(n_frames, frame_length) windowed fp32 frames with a high dynamic
  range, for holding K1 to its plain version: 40 harmonics of an f0 drawn
  from 80-400 Hz, the h-th at amplitude h^-3 (full scale at h = 1) with a
  random phase, below Nyquist only, plus white noise at -100 dB of full
  scale.  The mel bands then span about 80 dB, where white noise puts
  about equal power in every bin, so low-energy bins show an FFT's
  rounding.  Drawn with numpy from `seed`, summed in float64 on
  `device`."""
  rs = np.random.RandomState(seed)
  length, sr = config.frame_length, config.sr
  f0 = rs.uniform(80.0, 400.0, (n_frames, 1))
  phase = rs.uniform(0.0, 2.0 * np.pi, (n_frames, 40))
  noise = rs.randn(n_frames, length) * 1e-5
  t = torch.arange(length, dtype=torch.float64, device=device)
  f0 = torch.from_numpy(f0).to(device)
  phase = torch.from_numpy(phase).to(device)
  x = torch.from_numpy(noise).to(device)
  for h in range(1, 41):
    amp = h ** -3.0 * (h * f0 < sr / 2)
    x += amp * torch.cos(2.0 * np.pi * h / sr * f0 * t + phase[:, h - 1:h])
  window = torch.from_numpy(config.window_fn).to(device)
  return (x.to(torch.float32) * window).contiguous()


def fft_plan(n_fft: int) -> List[Tuple[int, int]]:
  """The FFT kernel's passes over the M = n_fft/2-point complex FFT, as
  (ns, R): a radix-R Stockham pass after passes that span ns points.  A
  radix-2, 4 or 8 pass first takes the bits of M beyond a multiple of 4,
  then radix-16 passes (csrc/logmel_fft.cu, `plan`)."""
  log2_m = int(n_fft).bit_length() - 2
  radices = ([1 << (log2_m % 4)] if log2_m % 4 else []) + [16] * (log2_m // 4)
  plan, ns = [], 1
  for radix in radices:
    plan.append((ns, radix))
    ns *= radix
  return plan


def fft_twiddle_index(n_fft: int) -> np.ndarray:
  """The k of each entry exp(-2πi·k/n_fft) of the FFT kernel's twiddle
  table, in the kernel's order (``twiddle_count``, csrc/logmel_fft.cu):
  for each pass after the first (``fft_plan``), the twiddles
  exp(-2πi·r·j/(ns·R)) for j < ns and r = 1 .. R-1, at (R-1)·j + r-1;
  then the split step's exp(-2πi·k/n_fft) for k < n_fft/4."""
  parts = []
  for ns, radix in fft_plan(n_fft)[1:]:
    j, r = np.meshgrid(np.arange(ns), np.arange(1, radix), indexing="ij")
    parts.append((r * j * (n_fft // (radix * ns))).ravel())
  parts.append(np.arange(n_fft // 4))
  return np.concatenate(parts).astype(np.int64)


def fft_twiddles(n_fft: int) -> np.ndarray:
  """The FFT kernel's twiddle table: (K, 2) float32 (real, imaginary),
  computed in float64 and rounded once."""
  angle = -2.0 * np.pi * fft_twiddle_index(n_fft) / n_fft
  return np.stack([np.cos(angle), np.sin(angle)], axis=-1).astype(np.float32)


def _mel_bands(mel_t: torch.Tensor):
  """[lo, hi) of the rows where each column of mel_t is nonzero."""
  nonzero = (mel_t != 0).cpu().numpy()
  n_freqs = nonzero.shape[0]
  return [(int(np.argmax(col)), n_freqs - int(np.argmax(col[::-1])))
          if col.any() else (0, 0) for col in nonzero.T]


def fft_operands(bases: dict, n_fft: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """The FFT kernel's tables, built once and kept beside the config's other
  bases (``FeatureConfig.device_bases``):

  * ``twiddles`` (K, 2) float32, ``fft_twiddles(n_fft)``;
  * ``weights``: each mel filter's weights over its nonzero bins, packed
    one filter after another;
  * ``bands`` (n_mels, 4) int32: lo, hi, the offset of the filter's
    weights in ``weights``, and 0, so that the kernel skips only exact
    zeros.
  """
  if "logmel_fft_twiddles" not in bases:
    mel_t = bases["mel_t"]
    bands, weights, offset = [], [], 0
    for m, (lo, hi) in enumerate(_mel_bands(mel_t)):
      bands.append((lo, hi, offset, 0))
      weights.append(mel_t[lo:hi, m])
      offset += hi - lo
    device = mel_t.device
    bases["logmel_fft_twiddles"] = torch.from_numpy(
        fft_twiddles(n_fft)).to(device)
    bases["logmel_fft_weights"] = torch.cat(weights).contiguous()
    bases["logmel_fft_bands"] = torch.tensor(bands, dtype=torch.int32,
                                             device=device)
  return (bases["logmel_fft_twiddles"], bases["logmel_fft_weights"],
          bases["logmel_fft_bands"])


def _library() -> ctypes.CDLL:
  lib = _build.load("logmel")
  fn = lib.odin_logmel
  if fn.argtypes is None:
    layout = lib.odin_logmel_bases_layout
    layout.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    layout.restype = None
    consts = [ctypes.c_int() for _ in range(3)]
    layout(*(ctypes.byref(c) for c in consts))
    if tuple(c.value for c in consts) != (CHUNK, MAX_FREQS, TILE_FRAMES):
      raise RuntimeError("csrc/logmel.cu and ops/logmel.py disagree on the "
                         "layout of the bases")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
  return lib


def kernel_operands(bases: dict) -> Tuple[torch.Tensor, torch.Tensor]:
  """The DFT bases and the mel bands in the kernel's layout, built once and
  kept beside the config's other bases (``FeatureConfig.device_bases``):

  * ``dft`` (groups, ceil(frame_length / CHUNK) * CHUNK, 2, MAX_FREQS),
    one group for each MAX_FREQS bins: row t of group g holds cos then sin
    of sample t at the bins g·MAX_FREQS + (0 .. MAX_FREQS − 1), zero past
    n_freqs; the padded rows are zero;
  * ``bands`` (n_mels, 2) int32: the rows [lo, hi) where mel_t's column is
    nonzero, so that the kernel skips only exact zeros.
  """
  if "logmel_dft" not in bases:
    cos_b, sin_b, mel_t = bases["cos"], bases["sin"], bases["mel_t"]
    frame_length, n_freqs = cos_b.shape
    padded = -(-frame_length // CHUNK) * CHUNK
    groups = -(-n_freqs // MAX_FREQS)
    dft = torch.zeros(groups, padded, 2, MAX_FREQS, dtype=torch.float32,
                      device=cos_b.device)
    for g in range(groups):
      bins = slice(g * MAX_FREQS, min((g + 1) * MAX_FREQS, n_freqs))
      n = bins.stop - bins.start
      dft[g, :frame_length, 0, :n] = cos_b[:, bins]
      dft[g, :frame_length, 1, :n] = sin_b[:, bins]
    bands = _mel_bands(mel_t)
    bases["logmel_dft"] = dft
    bases["logmel_bands"] = torch.tensor(bands, dtype=torch.int32,
                                         device=cos_b.device)
  return bases["logmel_dft"], bases["logmel_bands"]


def _fft_library() -> ctypes.CDLL:
  lib = _build.load("logmel_fft")
  fn = lib.odin_logmel_fft
  if fn.argtypes is None:
    limits = lib.odin_logmel_fft_limits
    limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    limits.restype = None
    lo, hi = ctypes.c_int(), ctypes.c_int()
    limits(ctypes.byref(lo), ctypes.byref(hi))
    count = lib.odin_logmel_fft_twiddle_count
    count.argtypes = [ctypes.c_int]
    count.restype = ctypes.c_int
    if (lo.value, hi.value) != FFT_LOG2_RANGE or any(
        count(k) != len(fft_twiddle_index(2 ** k))
        for k in range(lo.value, hi.value + 1)):
      raise RuntimeError("csrc/logmel_fft.cu and ops/logmel.py disagree on "
                         "the range of n_fft or the twiddle table")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
  return lib


def _launch(kernel: str, frames: torch.Tensor, config: "FeatureConfig",
            out: torch.Tensor) -> None:
  """Launches one K1 kernel, ``"fft"`` or ``"dense"``, on (n, frame_length)
  CUDA frames into (n, n_mels) ``out`` on the current stream; raises if the
  launch fails.  Counts nothing: ``logmel`` does."""
  bases = config.device_bases(frames.device)
  n = frames.numel() // config.frame_length
  stream = torch.cuda.current_stream(frames.device).cuda_stream
  with torch.cuda.device(frames.device):
    if kernel == "fft":
      twiddles, weights, bands = fft_operands(bases, config.n_fft)
      err = _fft_library().odin_logmel_fft(
          frames.data_ptr(), twiddles.data_ptr(), weights.data_ptr(),
          bands.data_ptr(), out.data_ptr(), n, config.frame_length,
          config.n_fft.bit_length() - 1, config.n_mels, weights.numel(),
          float(config.scale ** 2), stream)
    else:
      dft, bands = kernel_operands(bases)
      err = _library().odin_logmel(
          frames.data_ptr(), dft.data_ptr(), bases["mel_t"].data_ptr(),
          bands.data_ptr(), out.data_ptr(), n, config.frame_length,
          config.n_fft // 2 + 1, config.n_mels, float(config.scale ** 2),
          stream)
  if err != 0:
    raise RuntimeError(f"logmel {kernel} kernel launch failed with CUDA "
                       f"error {err}")


def logmel(frames_windowed: torch.Tensor,
           config: "FeatureConfig") -> torch.Tensor:
  """(..., frame_length) fp32 contiguous windowed frames -> (..., n_mels).

  ``logmel.launches`` counts the launches of both kernels,
  ``logmel.fft_launches`` the FFT kernel's share."""
  frame_length = config.frame_length
  if frames_windowed.dtype != torch.float32:
    raise TypeError(f"logmel takes float32 frames, got {frames_windowed.dtype}")
  if frames_windowed.ndim < 1 or frames_windowed.shape[-1] != frame_length:
    raise ValueError(f"logmel takes (..., {frame_length}) frames, got "
                     f"{tuple(frames_windowed.shape)}")
  if not frames_windowed.is_contiguous():
    raise ValueError("logmel takes contiguous frames")
  device = frames_windowed.device
  if device.type not in ("cpu", "cuda"):
    raise ValueError(f"logmel runs on 'cpu' or 'cuda', not {device}")
  if device.type == "cpu":
    bases = config.device_bases(device)
    return logmel_reference(frames_windowed, bases["cos"], bases["sin"],
                            bases["mel_t"], config.scale ** 2)

  out = torch.empty(frames_windowed.shape[:-1] + (config.n_mels,),
                    dtype=torch.float32, device=device)
  if out.numel() == 0:
    return out
  kernel = kernel_route(config.n_fft)
  _launch(kernel, frames_windowed, config, out)
  logmel.launches += 1
  if kernel == "fft":
    logmel.fft_launches += 1
  return out


logmel.launches = 0
logmel.fft_launches = 0
