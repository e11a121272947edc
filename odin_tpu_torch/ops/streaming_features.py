"""Streaming (online) speech features with carried state (PyTorch port of
``odin_tpu/ops/streaming_features.py``).

  state = streaming_init(cfg, batch, device=...)
  state, out = streaming_step(cfg, state, chunk)
  feats = streaming_finalize(cfg, state, [out1, out2, ...])

The concatenated per-chunk log-mels, MFCCs and energies over the valid
frame slots equal the offline ``speech_features`` on the concatenated
waveform.  The per-utterance top-dB clip, CMVN and the energy VAD are
whole-utterance statistics: ``streaming_finalize`` applies the clip from
the running max carried in the state and recomputes CMVN and VAD from the
clipped features.  Deltas need future frames: apply
``ops.features._batch_delta`` to the finalized features.

The state carries the last ``ceil((L - S)/S) * S`` samples, so that frame
starts stay on the global step grid; each step emits ``chunk_len // S``
frame slots, masked by ``frame_mask`` where a slot's frame starts before
the stream or runs past the samples consumed.  The step computes its DFT
with the plain matmul, as the JAX step does: it returns the power spectrum
``spec``, which K1 never gives out.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple, Union

import numpy as np
import torch

from odin_tpu_torch.device import resolve_device
from odin_tpu_torch.ops.features import FeatureConfig, frame_signal
from odin_tpu_torch.ops.logmel import power_spectrum

__all__ = ["StreamState", "streaming_init", "streaming_step",
           "streaming_finalize", "carry_samples"]


def carry_samples(config: FeatureConfig) -> int:
  """Carried samples: L - S rounded up to a step multiple, so frame starts
  stay on the global step grid across chunks."""
  L, S = config.frame_length, config.step_length
  return int(np.ceil((L - S) / S)) * S


class StreamState(NamedTuple):
  carry: torch.Tensor       # (B, carry_samples) trailing raw samples
  pre_last: torch.Tensor    # (B, 1) last raw sample before the carry
  n_consumed: int           # samples consumed so far
  ref_max: torch.Tensor     # (B, 1, 1) running max of the raw log-mel


def streaming_init(config: FeatureConfig, batch: int,
                   device: Union[str, torch.device] = "cuda") -> StreamState:
  device = resolve_device(device)
  Cr = carry_samples(config)
  return StreamState(
      carry=torch.zeros((batch, Cr), dtype=torch.float32, device=device),
      pre_last=torch.zeros((batch, 1), dtype=torch.float32, device=device),
      n_consumed=0,
      ref_max=torch.full((batch, 1, 1), -1e30, dtype=torch.float32,
                         device=device))


def streaming_step(config: FeatureConfig, state: StreamState, chunk
                   ) -> Tuple[StreamState, Dict[str, torch.Tensor]]:
  """Consume one (B, C) chunk (C a multiple of step_length; int16 or
  float32, numpy or tensor) on the state's device and emit C // step_length
  frame slots of raw (unclipped, unnormalized) features and their mask."""
  L, S = config.frame_length, config.step_length
  device = state.carry.device
  chunk = torch.as_tensor(chunk).to(device)
  if chunk.ndim == 1:
    chunk = chunk[None]
  if chunk.dtype == torch.int16:
    chunk = chunk.to(torch.float32) * (1.0 / 32768.0)
  chunk = chunk.to(torch.float32)
  B, C = chunk.shape
  if C % S:
    raise ValueError(f"chunk length {C} must be a multiple of step {S}")
  Cr = carry_samples(config)
  if Cr + C < L:
    raise ValueError(f"chunk too short: carry {Cr} + chunk {C} < frame {L}")
  n_out = C // S

  ext = torch.cat([state.carry, chunk], dim=1)  # (B, Cr + C)
  # pre-emphasis over the extended window; position 0's predecessor (the
  # sample just before the carry) is carried in pre_last
  prev = torch.cat([state.pre_last, ext[:, :-1]], dim=1)
  pe = ext - config.preemphasis * prev
  # the stream's first sample stays raw; on the first chunk it sits at ext
  # position Cr, right after the zero carry
  if state.n_consumed == 0:
    pe[:, Cr] = ext[:, Cr]

  starts = np.arange(n_out) * S
  take = int(starts[-1]) + L  # samples of ext the last frame needs
  if take > Cr + C:
    # the last frame slots read past the chunk: frame them against zeros
    pe = torch.nn.functional.pad(pe, (0, take - (Cr + C)))
  bases = config.device_bases(device)
  frames_w = frame_signal(pe[:, :take], L, S) * bases["window"]
  energy = torch.sum(frames_w * frames_w, dim=-1)
  energy = torch.log(torch.clamp(energy, min=float(np.finfo(np.float32).eps)))

  spec = power_spectrum(frames_w, bases["cos"], bases["sin"],
                        config.scale ** 2)
  mel = torch.matmul(spec, bases["mel_t"])
  mspec_raw = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
  mfcc_raw = torch.matmul(mspec_raw, bases["dct_t"])
  if config.remove_first_coef:
    mfcc_raw = mfcc_raw[..., 1:]

  # valid: the global start is >= 0 and the frame lies inside the stream
  g_start = state.n_consumed - Cr + starts
  valid = (g_start >= 0) & (g_start + L <= state.n_consumed + C)
  mask = torch.from_numpy(valid).to(device)[None, :].expand(B, n_out)

  neg = torch.full((), -1e30, device=device)
  new_state = StreamState(
      carry=ext[:, -Cr:] if Cr else ext[:, :0],
      pre_last=ext[:, -Cr - 1:-Cr] if Cr else ext[:, -1:],
      n_consumed=state.n_consumed + C,
      ref_max=torch.maximum(state.ref_max, torch.amax(
          torch.where(mask[..., None], mspec_raw, neg), dim=(-2, -1),
          keepdim=True)))
  out = dict(mspec_raw=mspec_raw, mfcc_raw=mfcc_raw,
             energy=energy[..., None], frame_mask=mask, spec=spec)
  return new_state, out


def streaming_finalize(config: FeatureConfig, state: StreamState,
                       outputs: List[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
  """Concatenate the per-chunk outputs and apply the whole-utterance
  statistics: the top-dB clip from the running max in the state, then CMVN
  and the energy VAD from the clipped features.  Returns the offline
  ``speech_features`` keys over the emitted slots."""
  cat = {k: torch.cat([o[k] for o in outputs], dim=1) for k in outputs[0]}
  mask = cat.pop("frame_mask")
  mspec = torch.maximum(cat.pop("mspec_raw"), state.ref_max - config.top_db)
  # the clip shifts the MFCCs wherever it bites: recompute them from the
  # clipped mels
  mfcc = torch.matmul(mspec, config.device_bases(mspec.device)["dct_t"])
  if config.remove_first_coef:
    mfcc = mfcc[..., 1:]
  energy = cat["energy"][..., 0]
  e_valid = torch.where(mask, energy, torch.full((), float("nan"),
                                                 device=energy.device))
  e_mean = torch.nanmean(e_valid, dim=1, keepdim=True)
  e_std = torch.sqrt(torch.nanmean((e_valid - e_mean) ** 2, dim=1,
                                   keepdim=True))
  vad = (energy > (e_mean - 0.5 * e_std)) & mask
  out = dict(mspec=mspec, mfcc=mfcc, energy=cat["energy"],
             frame_mask=mask, vad=vad, spec=cat["spec"])
  if config.cmvn:
    m = mask[..., None].to(mspec.dtype)
    denom = torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1.0)
    for key, f in (("mspec", mspec), ("mfcc", mfcc)):
      mu = torch.sum(f * m, dim=1, keepdim=True) / denom
      var = torch.sum((f - mu) ** 2 * m, dim=1, keepdim=True) / denom
      out[key + "_cmvn"] = (f - mu) / torch.clamp(torch.sqrt(var), min=1e-20)
  return out
