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

__all__ = ["logmel", "logmel_reference"]

# the kernel's constants (csrc/logmel.cu); `_library` checks them
CHUNK = 8  # kChunk: sample rows per staged chunk of the bases
MAX_FREQS = 288  # kMaxFreqs
_TILE_FRAMES = 32  # kTileFrames
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper


def logmel_reference(frames: torch.Tensor, cos_b: torch.Tensor,
                     sin_b: torch.Tensor, mel_t: torch.Tensor,
                     scale_sq: float) -> torch.Tensor:
  """Plain PyTorch K1: (..., frame_length) -> (..., n_mels), fp32."""
  re = torch.matmul(frames, cos_b)
  im = torch.matmul(frames, sin_b)
  power = (re * re + im * im) * scale_sq
  mel = torch.matmul(power, mel_t)
  return 10.0 * torch.log10(torch.clamp(mel, min=1e-10))


def _library() -> ctypes.CDLL:
  lib = _build.load("logmel")
  fn = lib.odin_logmel
  if fn.argtypes is None:
    chunk, max_freqs = ctypes.c_int(), ctypes.c_int()
    lib.odin_logmel_bases_layout(ctypes.byref(chunk), ctypes.byref(max_freqs))
    if (chunk.value, max_freqs.value) != (CHUNK, MAX_FREQS):
      raise RuntimeError("csrc/logmel.cu and ops/logmel.py disagree on the "
                         "layout of the bases")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
  return lib


def kernel_operands(bases: dict) -> Tuple[torch.Tensor, torch.Tensor]:
  """The DFT bases and the mel bands in the kernel's layout, built once and
  kept beside the config's other bases (``FeatureConfig.device_bases``):

  * ``dft`` (ceil(frame_length / CHUNK) * CHUNK, 2, MAX_FREQS): row t holds
    cos then sin of sample t, zero past n_freqs; the padded rows are zero;
  * ``bands`` (n_mels, 2) int32: the rows [lo, hi) where mel_t's column is
    nonzero, so that the kernel skips only exact zeros.
  """
  if "logmel_dft" not in bases:
    cos_b, sin_b, mel_t = bases["cos"], bases["sin"], bases["mel_t"]
    frame_length, n_freqs = cos_b.shape
    padded = -(-frame_length // CHUNK) * CHUNK
    dft = torch.zeros(padded, 2, MAX_FREQS, dtype=torch.float32,
                      device=cos_b.device)
    dft[:frame_length, 0, :n_freqs] = cos_b
    dft[:frame_length, 1, :n_freqs] = sin_b
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

  if n_freqs > MAX_FREQS:
    raise ValueError(f"the logmel kernel takes at most {MAX_FREQS} bins "
                     f"(n_fft {config.n_fft} gives {n_freqs})")
  padded = -(-frame_length // CHUNK) * CHUNK
  if 4 * (2 * CHUNK * 2 * MAX_FREQS + _TILE_FRAMES * max(padded, n_freqs)) \
      > _SMEM_LIMIT:
    raise ValueError(f"frame_length {frame_length} needs more shared memory "
                     "than a block has")
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
