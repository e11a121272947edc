"""``Bernoulli`` of the port (``odin_tpu/bay/distributions/discrete.py:51``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from odin_tpu_torch.bay.distributions.base import Distribution, register_kl

__all__ = ["Bernoulli"]


class Bernoulli(Distribution):
  """Bernoulli over its logits (the only parametrisation the image heads
  build)."""

  def __init__(self, logits):
    self.logits = torch.as_tensor(logits)

  @property
  def batch_shape(self):
    return self.logits.shape

  @property
  def probs(self):
    return torch.sigmoid(self.logits)

  def log_prob(self, x):
    # -BCE(x, sigmoid(logits)), valid for soft targets x in [0, 1]
    lp1 = -F.softplus(-self.logits)  # log sigmoid
    lp0 = -F.softplus(self.logits)  # log (1 - sigmoid)
    return x * lp1 + (1.0 - x) * lp0

  def mean(self):
    return self.probs

  def mode(self):
    return (self.logits > 0).to(torch.float32)

  def variance(self):
    p = self.probs
    return p * (1.0 - p)


@register_kl(Bernoulli, Bernoulli)
def _kl_bernoulli(q: Bernoulli, p: Bernoulli):
  pq = q.probs
  lq1, lq0 = -F.softplus(-q.logits), -F.softplus(q.logits)
  lp1, lp0 = -F.softplus(-p.logits), -F.softplus(p.logits)
  return pq * (lq1 - lp1) + (1.0 - pq) * (lq0 - lp0)
