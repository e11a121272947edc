"""KL divergence of the port (PyTorch port of ``kl_divergence``,
``odin_tpu/bay/helpers.py:21-65``): the closed form where one is
registered and asked for, else the Monte-Carlo estimate
``E_a[log a - log b]``, with `reverse` and per-unit free bits."""
from __future__ import annotations

from typing import Optional, Union

import torch

from odin_tpu_torch.bay.distributions import Distribution
from odin_tpu_torch.bay.distributions.base import (exact_kl,
                                                   kl_registry_lookup)

__all__ = ["kl_divergence"]


def kl_divergence(q: Distribution,
                  p: Distribution,
                  analytic: bool = False,
                  q_sample: Optional[Union[int, torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None,
                  reverse: bool = True,
                  free_bits: Optional[float] = None) -> torch.Tensor:
  """KL divergence between two distributions.

  Args:
    q: posterior distribution.
    p: prior distribution.
    analytic: use the closed-form KL when one is registered.
    q_sample: pre-drawn samples (a tensor), or an int number of MC samples
      to draw from `generator`.  Samples with more dims than the
      distribution's batch and event dims carry a leading sample axis, and
      the estimate is their mean over that first axis.
    generator: the ``torch.Generator`` the samples are drawn from.
    reverse: KL(q||p) if True (the ELBO's direction), else KL(p||q); the
      samples are drawn from (or given for) the first of the two.
    free_bits: clamp the KL to at least ``free_bits * prod(event_shape)``.
  """
  a, b = (q, p) if reverse else (p, q)
  if analytic and kl_registry_lookup(type(a), type(b)) is not None:
    kl = exact_kl(a, b)
  else:
    if isinstance(q_sample, (int, float)) or q_sample is None:
      if generator is None:
        raise ValueError("an MC KL needs q_sample or a generator")
      samples = a.sample((1 if q_sample is None else int(q_sample),),
                         generator=generator)
    else:
      samples = q_sample
    kl = a.log_prob(samples) - b.log_prob(samples)
    if samples.ndim > len(a.batch_shape) + len(a.event_shape):
      kl = torch.mean(kl, dim=0)
  if free_bits is not None:
    units = 1.0
    for d in a.event_shape:
      units *= float(d)
    kl = torch.clamp(kl, min=free_bits * units)
  return kl
