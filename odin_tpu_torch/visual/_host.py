"""Tensors into the plots: every plotting function of ``visual`` takes
tensors (on any device, with or without a gradient) where the JAX package's
takes arrays, and copies them to the host first."""
from __future__ import annotations

import functools

import torch


def to_host(x):
  """`x` with every tensor in it (also inside a list, tuple or dict) copied
  to the host as a numpy array (``.detach().cpu().numpy()``; bfloat16 goes
  through float32, which numpy has); anything else as it is."""
  if isinstance(x, torch.Tensor):
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
  if isinstance(x, (list, tuple)):
    items = [to_host(v) for v in x]
    if all(a is b for a, b in zip(items, x)):
      return x
    return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
  if isinstance(x, dict):
    items = {k: to_host(v) for k, v in x.items()}
    if all(items[k] is v for k, v in x.items()):
      return x
    return items
  return x


def host_arrays(fn):
  """`fn` taking tensors: its arguments go through ``to_host`` first."""

  @functools.wraps(fn)
  def wrapped(*args, **kwargs):
    return fn(*(to_host(a) for a in args),
              **{k: to_host(v) for k, v in kwargs.items()})

  return wrapped
