"""K1: fused window-DFT-power-mel-log, a hand-written CUDA kernel.

``logmel`` takes windowed frames and returns ``10·log10(max(mel power,
1e-10))``, unclipped (top-dB applies outside with the per-utterance max).
On a CUDA tensor it launches ``csrc/logmel.cu`` (which replaces
``_logmel_kernel``, ``odin_tpu/ops/pallas_features.py:32-39``) and raises if
the launch fails; there is no fallback.  On a CPU tensor it runs
``logmel_reference``, the plain PyTorch version of the same function.  The
kernel's bound on the card and its design are noted in the CUDA source.
"""
from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Tuple

import numpy as np
import torch

from odin_tpu_torch import _build

if TYPE_CHECKING:
  from odin_tpu_torch.ops.features import FeatureConfig

__all__ = ["logmel", "logmel_reference", "power_spectrum"]

# the kernel's constants (csrc/logmel.cu); `_library` checks them
CHUNK = 8  # kChunk: sample rows per staged chunk of the bases
MAX_FREQS = 288  # kMaxFreqs: bins per group of the bases
TILE_FRAMES = 32  # kTileFrames: frames per block


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
    nonzero = (mel_t != 0).cpu().numpy()
    bands = [(int(np.argmax(col)), n_freqs - int(np.argmax(col[::-1])))
             if col.any() else (0, 0) for col in nonzero.T]
    bases["logmel_dft"] = dft
    bases["logmel_bands"] = torch.tensor(bands, dtype=torch.int32,
                                         device=cos_b.device)
  return bases["logmel_dft"], bases["logmel_bands"]


def logmel(frames_windowed: torch.Tensor,
           config: "FeatureConfig") -> torch.Tensor:
  """(..., frame_length) fp32 contiguous windowed frames -> (..., n_mels)."""
  frame_length = config.frame_length
  n_freqs = config.n_fft // 2 + 1
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
  bases = config.device_bases(device)
  if device.type == "cpu":
    return logmel_reference(frames_windowed, bases["cos"], bases["sin"],
                            bases["mel_t"], config.scale ** 2)

  lead = frames_windowed.shape[:-1]
  n = frames_windowed.numel() // frame_length
  out = torch.empty(lead + (config.n_mels,), dtype=torch.float32,
                    device=device)
  if n == 0:
    return out
  lib = _library()
  dft, bands = kernel_operands(bases)
  with torch.cuda.device(device):
    err = lib.odin_logmel(
        frames_windowed.data_ptr(), dft.data_ptr(), bases["mel_t"].data_ptr(),
        bands.data_ptr(), out.data_ptr(), n, frame_length, n_freqs,
        config.n_mels, float(config.scale ** 2),
        torch.cuda.current_stream(device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"logmel kernel launch failed with CUDA error {err}")
  logmel.launches += 1
  return out


logmel.launches = 0
