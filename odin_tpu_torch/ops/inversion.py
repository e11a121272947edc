"""Batched spectrogram inversion on the device: STFT, inverse STFT and
Griffin-Lim (PyTorch port of ``odin_tpu/ops/inversion.py``).

  * the inverse real FFT is a product with weighted cos/sin bases, as the
    forward DFT of ``ops.features``, in fp32;
  * overlap-add is one ``index_add_`` over precomputed frame indices,
    normalized by the window-square envelope;
  * Griffin-Lim iterates iSTFT -> STFT -> keep the angles in a loop.

``istft_device`` equals the host ``istft`` of the JAX package on the same
complex input to fp32 tolerance, and the forward/backward pair satisfies
COLA away from the edges.  Griffin-Lim draws its initial phase from a
``torch.Generator``; ``init_phase=`` takes given angles instead, so that a
run can start from another package's draw.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from odin_tpu_torch.device import resolve_device
from odin_tpu_torch.preprocessing import signal as np_signal

__all__ = ["stft_device", "istft_device", "griffin_lim_device"]


def _fwd_bases(frame_length: int, n_fft: int):
  """rFFT cos/sin bases so that re = x@cos, im = x@(-sin)."""
  t = np.arange(frame_length)[:, None]
  k = np.arange(n_fft // 2 + 1)[None, :]
  ang = 2.0 * np.pi * t * k / n_fft
  return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def _inv_bases(frame_length: int, n_fft: int):
  """Weighted bases so that x[:frame_length] = re@C + im@S, the irfft of
  re + i*im: x[t] = (1/n) sum_k w_k (Re_k cos(2pi kt/n) - Im_k
  sin(2pi kt/n)), w_k = 1 at k in {0, n/2}, else 2."""
  K = n_fft // 2 + 1
  k = np.arange(K)[:, None]
  t = np.arange(frame_length)[None, :]
  w = np.full((K, 1), 2.0)
  w[0] = 1.0
  if n_fft % 2 == 0:
    w[-1] = 1.0
  ang = 2.0 * np.pi * k * t / n_fft
  C = (w * np.cos(ang) / n_fft).astype(np.float32)
  S = (-w * np.sin(ang) / n_fft).astype(np.float32)
  return C, S


def _params(frame_length: int, step_length: Optional[int],
            n_fft: Optional[int], window: str):
  step = int(step_length) if step_length else frame_length // 4
  nf = int(n_fft) if n_fft else int(2 ** np.ceil(np.log2(frame_length)))
  w = np_signal.get_window(window, frame_length, periodic=True) \
      .astype(np.float32)
  scale = float(1.0 / w.sum())  # sqrt(1 / sum(w)^2), the host convention
  return step, nf, w, scale


@functools.lru_cache(maxsize=32)
def _operands(frame_length: int, n_fft: int, window: str,
              device: torch.device) -> Dict[str, torch.Tensor]:
  """The window and the forward and inverse bases on `device`, built once."""
  _, _, w, _ = _params(frame_length, None, n_fft, window)
  cos_b, msin_b = _fwd_bases(frame_length, n_fft)
  C, S = _inv_bases(frame_length, n_fft)
  arrays = dict(window=w, cos=cos_b, msin=msin_b, inv_cos=C, inv_sin=S)
  return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


@functools.lru_cache(maxsize=32)
def _overlap(frame_length: int, step: int, n_frames: int, window: str,
             device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
  """The overlap-add's sample index of every frame slot, (F·L,), and the
  window-square envelope it divides by, (n,), on `device`."""
  _, _, w, _ = _params(frame_length, step, None, window)
  n = frame_length + step * (n_frames - 1)
  idx = ((np.arange(n_frames) * step)[:, None] +
         np.arange(frame_length)).ravel()
  norm = np.zeros(n, np.float32)
  np.add.at(norm, idx, np.tile(w ** 2, n_frames))
  return (torch.from_numpy(idx).to(device),
          torch.from_numpy(np.maximum(norm, 1e-8)).to(device))


def stft_device(y, frame_length: int, step_length: Optional[int] = None,
                n_fft: Optional[int] = None, window: str = "hann",
                device: Union[str, torch.device] = "cuda"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(B, T) -> (re, im), each (B, n_frames, n_fft//2+1), on `device`, with
  the host ``stft`` conventions (frames at t*step, window, sqrt(1/sum(w)^2)
  scaling)."""
  device = resolve_device(device)
  step, nf, _, scale = _params(frame_length, step_length, n_fft, window)
  y = torch.as_tensor(y).to(device=device, dtype=torch.float32)
  if y.ndim == 1:
    y = y[None]
  ops = _operands(frame_length, nf, window, device)
  frames = y.unfold(-1, frame_length, step) * ops["window"]
  re = torch.matmul(frames, ops["cos"]) * scale
  im = torch.matmul(frames, ops["msin"]) * scale
  return re, im


def istft_device(re, im, frame_length: int,
                 step_length: Optional[int] = None, window: str = "hann",
                 device: Union[str, torch.device] = "cuda") -> torch.Tensor:
  """Batched inverse STFT by overlap-add (the host ``istft`` semantics):
  (B, F, K) re/im -> (B, T) waveforms on `device`."""
  device = resolve_device(device)
  re = torch.as_tensor(re).to(device=device, dtype=torch.float32)
  im = torch.as_tensor(im).to(device=device, dtype=torch.float32)
  K = re.shape[-1]
  nf = 2 * (K - 1)
  step, _, _, scale = _params(frame_length, step_length, nf, window)
  if re.ndim == 2:
    re, im = re[None], im[None]
  B, F, _ = re.shape
  ops = _operands(frame_length, nf, window, device)
  frames = (torch.matmul(re / scale, ops["inv_cos"]) +
            torch.matmul(im / scale, ops["inv_sin"]))
  frames = frames * ops["window"]  # windowed overlap-add
  idx, norm = _overlap(frame_length, step, F, window, device)
  y = torch.zeros((B, norm.shape[0]), dtype=frames.dtype, device=device)
  y.index_add_(1, idx, frames.reshape(B, -1))
  return y / norm


def griffin_lim_device(spec_mag, frame_length: int,
                       step_length: Optional[int] = None, n_iter: int = 30,
                       window: str = "hann",
                       generator: Optional[torch.Generator] = None,
                       init_phase=None,
                       device: Union[str, torch.device] = "cuda"
                       ) -> torch.Tensor:
  """Batched Griffin-Lim (the host ``griffin_lim``): (B, F, K) magnitudes ->
  (B, T) waveforms on `device`.  The initial angles are `init_phase`
  (B, F, K) when given, else uniform in [0, 2pi) from `generator` (seeded
  with 1 by default, as the JAX package's default key)."""
  device = resolve_device(device)
  spec_mag = torch.as_tensor(spec_mag).to(device=device, dtype=torch.float32)
  if spec_mag.ndim == 2:
    spec_mag = spec_mag[None]
  step = int(step_length) if step_length else frame_length // 4
  if init_phase is None:
    if generator is None:
      generator = torch.Generator(device).manual_seed(1)
    ang0 = torch.rand(spec_mag.shape, generator=generator,
                      device=device) * (2 * np.pi)
  else:
    ang0 = torch.as_tensor(init_phase).to(device=device, dtype=torch.float32)
  cre, cim = torch.cos(ang0), torch.sin(ang0)
  n_fft = 2 * (spec_mag.shape[-1] - 1)
  F = spec_mag.shape[1]
  for _ in range(int(n_iter)):
    y = istft_device(spec_mag * cre, spec_mag * cim, frame_length, step,
                     window, device=device)
    re, im = stft_device(y, frame_length, step, n_fft=n_fft, window=window,
                         device=device)
    re, im = re[:, :F], im[:, :F]
    mag = torch.clamp(torch.sqrt(re * re + im * im), min=1e-12)
    cre, cim = re / mag, im / mag
  return istft_device(spec_mag * cre, spec_mag * cim, frame_length, step,
                      window, device=device)
