"""Device selection shared by the port's entry points."""
from __future__ import annotations

import math
from typing import Callable, Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "device_of", "as_tensor", "iterate"]


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


def iterate(step: Callable[[], None], stopped: Callable[[], bool],
            device: torch.device, max_iter: float = math.inf,
            unroll: int = 64, check_every: int = 1) -> int:
  """Run `step` (which updates its state in place and leaves a stopped
  state as it is) until `stopped()` (read on the host) or `max_iter`
  steps.  On the card the steps after the first run as a CUDA graph of
  `unroll` steps, replayed, with `stopped()` read between replays (the
  last steps below `max_iter` run one by one); on the CPU they run
  eagerly, `stopped()` read every `check_every` steps.  Returns the steps
  run."""
  it = 0
  if device.type != "cuda":
    while it < max_iter:
      step()
      it += 1
      if it % check_every == 0 and stopped():
        break
    return it
  side = torch.cuda.Stream(device)
  side.wait_stream(torch.cuda.current_stream(device))
  with torch.cuda.stream(side):  # the first step warms up the capture
    step()
  torch.cuda.current_stream(device).wait_stream(side)
  it = 1
  if it + unroll <= max_iter and not stopped():
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
      for _ in range(unroll):
        step()
    while it + unroll <= max_iter and not stopped():
      graph.replay()
      it += unroll
  while it < max_iter and not stopped():
    step()
    it += 1
  return it
