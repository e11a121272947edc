"""Corpus feature extraction on padded batches (PyTorch port of
``batch_speech_features``, ``odin_tpu/preprocessing/processor.py:172-235``).
``DeviceCorpusProcessor`` is not ported yet."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from odin_tpu_torch.device import resolve_device

__all__ = ["batch_speech_features"]


def batch_speech_features(utterances: Sequence[np.ndarray],
                          config=None,
                          batch_size: int = 64,
                          features: Sequence[str] = ("mspec", "mfcc", "vad"),
                          pad_to: Optional[int] = None,
                          transfer_dtype: Optional[Any] = None,
                          device: Union[str, torch.device] = "cuda"
                          ) -> List[Dict[str, np.ndarray]]:
  """Pad utterances into fixed-shape batches, run the fused pipeline once
  per batch on `device`, and strip the padding from each utterance.

  Raw-transfer policy: when every utterance is int16 PCM (or uint8 G.711
  mu-law codewords), the batch crosses to the device in that dtype and is
  rescaled or expanded there, 2x (4x for mu-law) fewer bytes than float32.
  ``transfer_dtype=np.float32`` forces the host-side conversion and
  ``np.int16`` forces raw PCM for float inputs.  On the card the host batch
  is pinned, so the copy is a DMA that does not stage through pageable
  memory.

  Every feature of ``speech_features`` may be asked for, as in the JAX
  package.  The log-mel core runs through K1 unless ``"spec"`` is in
  ``features``: the power spectrum never leaves K1, so then the batch
  takes ``speech_features(use_pallas=False)``, the plain matmul DFT, which
  returns it.  The caller's ``features`` make that choice; nothing falls
  back.
  """
  from odin_tpu_torch.ops.features import (FeatureConfig, speech_features,
                                           ulaw_expand_device)
  config = config or FeatureConfig()
  device = resolve_device(device)
  out: List[Dict[str, np.ndarray]] = []
  if pad_to is None:
    pad_to = max(len(u) for u in utterances)
  if transfer_dtype is None:
    dtypes = {np.asarray(u).dtype for u in utterances}
    transfer_dtype = dtypes.pop() if len(dtypes) == 1 and dtypes.issubset(
        {np.dtype(np.int16), np.dtype(np.uint8)}) else np.float32
  transfer_dtype = np.dtype(transfer_dtype)
  # mu-law code 0xFF decodes to exactly 0: the right pad value
  pad_value = 0xFF if transfer_dtype == np.uint8 else 0
  for i in range(0, len(utterances), batch_size):
    chunk = utterances[i:i + batch_size]
    lengths = np.array([min(len(u), pad_to) for u in chunk], np.int64)
    batch = np.full((len(chunk), pad_to), pad_value, transfer_dtype)
    for j, u in enumerate(chunk):
      u = np.asarray(u)[:pad_to]
      if u.dtype != transfer_dtype:
        if transfer_dtype == np.uint8:
          raise ValueError("uint8 (mu-law) transfer requires every "
                           "utterance to already hold G.711 codewords")
        if transfer_dtype == np.int16:
          u = np.clip(u * 32768.0, -32768, 32767).astype(np.int16)
        elif u.dtype == np.int16:
          u = u.astype(np.float32) * (1.0 / 32768.0)
        elif u.dtype == np.uint8:
          u = ulaw_expand_device(torch.from_numpy(u)).numpy()
        else:
          u = u.astype(transfer_dtype)
      batch[j, :lengths[j]] = u
    y = torch.from_numpy(batch)
    if device.type == "cuda":
      y = y.pin_memory().to(device, non_blocking=True)
    res = speech_features(y, config, lengths=torch.from_numpy(lengths),
                          device=device, use_pallas="spec" not in features)
    res = {k: v.cpu().numpy() for k, v in res.items()
           if k in features or k == "frame_mask"}
    for j in range(len(chunk)):
      n = int(res["frame_mask"][j].sum())
      out.append({k: v[j][:n] for k, v in res.items() if k != "frame_mask"})
  return out
