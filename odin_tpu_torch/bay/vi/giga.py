"""Information-gain estimators of the port (PyTorch port of
``odin_tpu/bay/vi/giga.py``): ``estimate_Izx`` (the minibatch
aggregate-posterior bound on I(z;x)) and ``estimate_Izy`` (the Gibbs
information gain H(y) - H(y|z) of a held-out logistic probe), on the device
of their inputs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from odin_tpu_torch.bay.distributions import Distribution
from odin_tpu_torch.bay.vi.estimators import (LogisticRegression, as_tensor,
                                              device_of, train_test_split)

__all__ = ["estimate_Izx", "estimate_Izy"]


def estimate_Izx(qz: Distribution, z: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> float:
  """I(z;x) >= ``E_i[log q(z_i|x_i) - log (1/N) Σ_j q(z_i|x_j)]`` for one
  sample z_i of each posterior (given, or drawn from `generator`)."""
  if z is None:
    if generator is None:
      raise ValueError("provide z samples or a generator")
    z = qz.sample(generator=generator)
  n = z.shape[0]
  lp = qz.log_prob(z[:, None, :] if z.ndim == 2 else z[:, None])  # (i, j)
  log_qz_agg = torch.logsumexp(lp, dim=1) - math.log(float(n))
  return float(torch.mean(torch.diagonal(lp) - log_qz_agg))


def estimate_Izy(z, y, seed: int = 1, test_size: float = 0.3,
                 device=None) -> float:
  """I(z;y) >= H(y) - H(y|z), in nats: H(y|z) is the held-out log-loss of
  a logistic probe fitted on a stratified split (scikit-learn's
  ``train_test_split(stratify=y)`` rows)."""
  dev = device_of(z, y, device=device)
  z = as_tensor(z, dev)
  y = as_tensor(y, dev).reshape(-1)
  _, counts = torch.unique(y, return_counts=True)
  p = counts.to(torch.float64) / counts.sum()
  h_y = float(-torch.sum(p * torch.log(p)))
  ztr, zte, ytr, yte = train_test_split(z, y, test_size=test_size,
                                        random_state=seed, stratify=y)
  probe = LogisticRegression().fit(ztr, ytr)
  proba = torch.clamp(probe.predict_proba(zte), 1e-12, 1.0)
  col = torch.searchsorted(probe.classes_, yte)
  ll = torch.log(proba.gather(1, col[:, None])[:, 0])
  return max(h_y - float(-torch.mean(ll)), 0.0)
