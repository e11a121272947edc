"""Probability-to-score transforms of the port (PyTorch port of
``odin_tpu/backend/maths.py``'s ``to_llh`` and ``to_llr``; its other
functions are ROADMAP.md queue 1, item 8).  Both run in float32, as JAX's
do, on the device of a tensor argument (the card for an array unless
`device` says otherwise)."""
from __future__ import annotations

import math

import torch

from odin_tpu_torch.device import as_tensor, device_of

__all__ = ["to_llh", "to_llr"]


def to_llh(x, device=None) -> torch.Tensor:
  """Probabilities -> log-likelihoods: each row normalised to sum 1, then
  ``log(clip(p, 1e-8, 1 - 1e-8))``."""
  x = as_tensor(x, device_of(x, device=device), torch.float32)
  x = x / torch.sum(x, dim=-1, keepdim=True)
  return torch.log(torch.clamp(x, 1e-8, 1.0 - 1e-8))


def to_llr(x, device=None) -> torch.Tensor:
  """Scores -> log-likelihood ratios of each class against the others:
  ``-logsumexp_{k≠j}(x_k − x_j) + log(max(L − 1, 1))`` for each class j of
  L."""
  x = as_tensor(x, device_of(x, device=device), torch.float32)
  n = x.shape[-1]
  rest = x[:, None, :] - x[:, :, None]  # [i, j, k] = x_k - x_j
  eye = torch.eye(n, dtype=torch.bool, device=x.device)
  rest = rest.masked_fill(eye, -math.inf)
  return -torch.logsumexp(rest, dim=2) + math.log(float(max(n - 1, 1)))
