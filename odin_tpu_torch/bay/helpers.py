"""KL divergence and concatenation of the port (PyTorch port of
``kl_divergence`` and ``concat_distributions``,
``odin_tpu/bay/helpers.py:21-88``): the closed form where one is
registered and asked for, else the Monte-Carlo estimate
``E_a[log a - log b]``, with `reverse` and per-unit free bits."""
from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence, Union

import torch

from odin_tpu_torch.bay.distributions import (Bernoulli, Distribution,
                                              Independent,
                                              MultivariateNormalDiag)
from odin_tpu_torch.bay.distributions.base import (exact_kl,
                                                   kl_registry_lookup)

__all__ = ["kl_divergence", "concat_distributions", "map_distributions"]

# the families a VAE of the port returns; JAX's ``Batchwise`` fallback for
# any other mix waits with the rest of the distribution zoo
_CONCAT_FAMILIES = (MultivariateNormalDiag, Bernoulli, Independent)


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


def map_distributions(fn: Callable[..., torch.Tensor],
                      *dists: Distribution) -> Distribution:
  """A copy of the first distribution whose tensors are ``fn`` of the
  matching tensors of all of them (the distribution an ``Independent``
  wraps too), as JAX's ``tree_map`` over distribution pytrees; the other
  fields must agree."""
  first = dists[0]
  if any(type(d) is not type(first) for d in dists):
    raise TypeError("cannot combine distributions of the families "
                    f"{sorted({type(d).__name__ for d in dists})}")
  out = copy.copy(first)
  for key, value in vars(first).items():
    others = [vars(d)[key] for d in dists]
    if isinstance(value, torch.Tensor):
      setattr(out, key, fn(*others))
    elif isinstance(value, Distribution):
      setattr(out, key, map_distributions(fn, *others))
    elif any(o != value for o in others):
      raise ValueError(f"the distributions differ in {key!r}: {others}")
  return out


def concat_distributions(distributions: Sequence[Distribution],
                         axis: int = 0) -> Distribution:
  """Concatenate same-family distributions along a batch axis (JAX's
  ``concat_distributions``, ``odin_tpu/bay/helpers.py:68``): their
  parameters are concatenated.  ``MultivariateNormalDiag``, ``Bernoulli``
  and ``Independent`` of those; another family raises."""
  distributions = list(distributions)
  if len(distributions) == 1:
    return distributions[0]

  def check(d):
    if not isinstance(d, _CONCAT_FAMILIES):
      raise NotImplementedError(
          f"concat_distributions of {type(d).__name__} is not ported yet "
          "(JAX's Batchwise waits with the rest of the distribution zoo, "
          "ROADMAP.md queue 1)")
    if isinstance(d, Independent):
      check(d.distribution)

  for d in distributions:
    check(d)
  return map_distributions(lambda *xs: torch.cat(xs, dim=axis),
                           *distributions)
