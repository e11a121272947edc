"""Distribution base classes of the port (PyTorch port of
``odin_tpu/bay/distributions/base.py``: ``Distribution`` :49,
``register_kl`` :156, ``Independent`` :187).

TFP conventions as in the JAX package: ``batch_shape`` + ``event_shape``,
``log_prob`` reduces over the event dims only, and ``Independent``
reinterprets trailing batch dims as event dims.  Sampling takes an explicit
``torch.Generator``, or the noise ``eps`` itself, so that a test can feed
both packages the same noise.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = ["Distribution", "Independent", "register_kl",
           "kl_registry_lookup", "exact_kl"]


class Distribution:
  """Base distribution over tensors; ``_params`` names the tensors that
  parametrise it (the JAX package's pytree leaves), from which ``dtype``
  is promoted."""

  _params: Tuple[str, ...] = ()

  @property
  def batch_shape(self) -> Tuple[int, ...]:
    raise NotImplementedError

  @property
  def event_shape(self) -> Tuple[int, ...]:
    return ()

  @property
  def dtype(self) -> torch.dtype:
    """The promoted dtype of the parameters (float32 where there are
    none)."""
    if not self._params:
      return torch.float32
    return functools.reduce(torch.promote_types,
                            (torch.as_tensor(getattr(self, n)).dtype
                             for n in self._params))

  def sample(self, sample_shape: Tuple[int, ...] = (),
             generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    raise NotImplementedError

  def sample_from(self, noise, sample_shape: Tuple[int, ...] = ()
                  ) -> torch.Tensor:
    """A sample whose draws come from a ``training.core.Noise``: one
    normal of ``sample_shape + batch_shape + event_shape`` by default (a
    reparameterised family); a family with other draws overrides it."""
    mean = self.mean()
    eps = noise.normal(tuple(sample_shape) + tuple(self.batch_shape) +
                       tuple(self.event_shape), mean.dtype, mean.device)
    return self.sample(sample_shape, eps=eps)

  def log_prob(self, x: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError

  def prob(self, x: torch.Tensor) -> torch.Tensor:
    return torch.exp(self.log_prob(x))

  def mean(self) -> torch.Tensor:
    raise NotImplementedError

  def mode(self) -> torch.Tensor:
    raise NotImplementedError

  def variance(self) -> torch.Tensor:
    raise NotImplementedError

  def stddev(self) -> torch.Tensor:
    return torch.sqrt(self.variance())

  def entropy(self) -> torch.Tensor:
    raise NotImplementedError

  def kl_divergence(self, other: "Distribution", analytic: bool = True,
                    samples: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    n_samples: int = 1) -> torch.Tensor:
    """KL(self || other): analytic where the pair is registered, else the
    Monte-Carlo ``E_q[log q(z) - log p(z)]`` averaged over the first axis
    of `samples`, drawn here (`n_samples` of them) from `generator` when
    not given."""
    if analytic:
      fn = kl_registry_lookup(type(self), type(other))
      if fn is not None:
        return fn(self, other)
    if samples is None:
      if generator is None:
        raise ValueError(
            f"no analytic KL for ({type(self).__name__}, "
            f"{type(other).__name__}) — provide `samples` or `generator` for "
            "an MC estimate")
      samples = self.sample((n_samples,), generator=generator)
    return torch.mean(self.log_prob(samples) - other.log_prob(samples),
                      dim=0)

  KL_divergence = kl_divergence

  def __repr__(self):
    return (f"{type(self).__name__}(batch_shape={tuple(self.batch_shape)}, "
            f"event_shape={tuple(self.event_shape)})")


_KL_REGISTRY: Dict[Tuple[type, type], Callable] = {}


def register_kl(type_q: type, type_p: type):
  """Decorator registering an analytic ``KL(q || p)`` for a type pair."""

  def wrap(fn):
    _KL_REGISTRY[(type_q, type_p)] = fn
    return fn

  return wrap


def kl_registry_lookup(type_q: type, type_p: type) -> Optional[Callable]:
  # exact, then MRO-based lookup so subclasses inherit KLs
  for tq in type_q.__mro__:
    for tp in type_p.__mro__:
      fn = _KL_REGISTRY.get((tq, tp))
      if fn is not None:
        return fn
  return None


def exact_kl(q: Distribution, p: Distribution) -> torch.Tensor:
  fn = kl_registry_lookup(type(q), type(p))
  if fn is None:
    raise NotImplementedError(
        f"no analytic KL registered for ({type(q).__name__}, {type(p).__name__})")
  return fn(q, p)


class Independent(Distribution):
  """Reinterpret the trailing `reinterpreted_batch_ndims` batch dims of a
  base distribution as event dims (log_prob sums over them)."""

  def __init__(self, distribution: Distribution,
               reinterpreted_batch_ndims: int = 1):
    self.distribution = distribution
    self.reinterpreted_batch_ndims = int(reinterpreted_batch_ndims)

  @property
  def batch_shape(self):
    b = tuple(self.distribution.batch_shape)
    k = self.reinterpreted_batch_ndims
    return b[:len(b) - k] if k > 0 else b

  @property
  def event_shape(self):
    b = tuple(self.distribution.batch_shape)
    k = self.reinterpreted_batch_ndims
    return (b[len(b) - k:] if k > 0 else ()) + tuple(
        self.distribution.event_shape)

  def _reduce(self, x):
    k = self.reinterpreted_batch_ndims
    return torch.sum(x, dim=tuple(range(-k, 0))) if k > 0 else x

  def sample(self, sample_shape=(), generator=None, eps=None):
    return self.distribution.sample(sample_shape, generator, eps)

  def log_prob(self, x):
    return self._reduce(self.distribution.log_prob(x))

  def mean(self):
    return self.distribution.mean()

  def mode(self):
    return self.distribution.mode()

  def variance(self):
    return self.distribution.variance()

  def stddev(self):
    return self.distribution.stddev()

  @property
  def dtype(self):
    return self.distribution.dtype

  def entropy(self):
    return self._reduce(self.distribution.entropy())


@register_kl(Independent, Independent)
def _kl_independent(q: Independent, p: Independent):
  if q.reinterpreted_batch_ndims != p.reinterpreted_batch_ndims:
    raise ValueError("Independent KL requires matching reinterpreted_batch_ndims")
  inner = exact_kl(q.distribution, p.distribution)
  k = q.reinterpreted_batch_ndims
  return torch.sum(inner, dim=tuple(range(-k, 0))) if k > 0 else inner
