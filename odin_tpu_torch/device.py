"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


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
