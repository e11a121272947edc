"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "device_of", "as_tensor"]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
  """Return `device` as a ``torch.device``; a CUDA device without a card
  raises, so that no entry point silently falls back to the CPU."""
  device = torch.device(device)
  if device.type == "cuda":
    if not torch.cuda.is_available():
      raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                         "the plain PyTorch versions on the CPU")
    if device.index is None:
      device = torch.device("cuda", torch.cuda.current_device())
  elif device.type != "cpu":
    raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
  return device


def device_of(*xs, device=None) -> torch.device:
  """`device` if given, else the device of the first tensor among `xs`,
  else the card (an entry point runs on the card unless asked for the
  CPU)."""
  if device is not None:
    return resolve_device(device)
  for x in xs:
    if isinstance(x, torch.Tensor):
      return x.device
  return resolve_device("cuda")


def as_tensor(x, device: Optional[torch.device] = None,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
  """`x` (a tensor, an array or a list) as a tensor on `device` (the
  tensor's own, or the card, when None)."""
  if isinstance(x, torch.Tensor):
    return x.to(device=x.device if device is None else device,
                dtype=x.dtype if dtype is None else dtype)
  return torch.as_tensor(np.asarray(x), dtype=dtype).to(
      device_of(device=device))
