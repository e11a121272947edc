"""Label embedders of the port (PyTorch port of
``odin_tpu/networks/conditional_embedding.py``: ``_to_indices`` :32,
``IdentityEmbedding`` :50, ``RepetitionEmbedding`` :61,
``DictionaryEmbedding`` :86, ``ProjectionEmbedding`` :102,
``SequentialEmbedding`` :124, ``get_embedding`` :150).

Each maps a batch of labels, int indices (B,) or one-hot/soft vectors
(B, n_classes), to a tensor of ``(B,) + event_shape`` that a conditional
encoder or decoder concatenates into its trunk.  The lookup embedders fold
soft labels by argmax (no gradient reaches the labels); the projection keeps
soft-label gradients, which M2's relaxed path needs.  Parameter names follow
flax's: a lookup table is ``table.embedding`` (flax's ``table/embedding``),
the projection ``proj.weight`` (``proj/kernel``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from odin_tpu_torch.networks.base import Dense, get_activation

__all__ = ["Embedder", "IdentityEmbedding", "RepetitionEmbedding",
           "DictionaryEmbedding", "ProjectionEmbedding",
           "SequentialEmbedding", "all_embedder", "get_embedding"]


def _as_shape(event_shape) -> Tuple[int, ...]:
  if isinstance(event_shape, (int, float)):
    return (int(event_shape),)
  return tuple(int(s) for s in event_shape)


def _to_indices(y: torch.Tensor) -> torch.Tensor:
  """(B,) class indices from int labels or one-hot/soft vectors (argmax of
  the last axis)."""
  if y.ndim >= 2 and y.shape[-1] > 1:
    return torch.argmax(y, dim=-1)
  return y.reshape(y.shape[:1]).to(torch.int64) if y.ndim > 1 \
      else y.to(torch.int64)


class Embedder(nn.Module):
  """A label embedder: `n_classes` classes to a tensor of `event_shape`
  per example."""

  def __init__(self, n_classes: int, event_shape: Sequence[int] = ()):
    super().__init__()
    self.n_classes = int(n_classes)
    self.event_shape = _as_shape(event_shape)

  @property
  def output_shape(self) -> Tuple[int, ...]:
    return self.event_shape

  def build(self, in_shape=None, generator=None):
    return self.event_shape


class IdentityEmbedding(Embedder):
  """The labels as they are."""

  def build(self, in_shape=None, generator=None):
    return tuple(in_shape) if in_shape is not None else self.event_shape

  def forward(self, y):
    return y


class RepetitionEmbedding(Embedder):
  """Labels broadcast and tiled over the leading event axes, so that they
  concatenate to a feature map: ``(B, n) -> (B, *event_shape[:-1], n)``
  (an axis of size 1 is repeated to the event's size)."""

  def forward(self, y):
    shape = self.event_shape
    if y.ndim == 1:
      y = y[:, None]
    if y.ndim > len(shape) + 1:
      raise ValueError(f"cannot broadcast labels {tuple(y.shape[1:])} to "
                       f"event_shape {shape}")
    while y.ndim < len(shape) + 1:
      y = y[:, None]
    reps = [1] + [shape[i] if (s == 1 and shape[i] != 1) else 1
                  for i, s in enumerate(y.shape[1:])]
    return y.repeat(*reps)


class _Table(nn.Module):
  """flax's ``nn.Embed``: a (num_embeddings, features) table drawn from a
  normal of standard deviation ``1/sqrt(features)``."""

  def __init__(self, num_embeddings: int, features: int):
    super().__init__()
    self.num_embeddings, self.features = int(num_embeddings), int(features)

  def build(self, generator=None):
    w = torch.empty(self.num_embeddings, self.features)
    with torch.no_grad():
      w.normal_(0.0, 1.0 / math.sqrt(self.features), generator=generator)
    self.embedding = nn.Parameter(w)

  def forward(self, idx):
    return F.embedding(idx, self.embedding)


class DictionaryEmbedding(Embedder):
  """A learned vector for each class, reshaped to `event_shape` (soft
  labels are folded by argmax first)."""

  def __init__(self, n_classes: int, event_shape: Sequence[int] = ()):
    super().__init__(n_classes, event_shape)
    self.table = _Table(self.n_classes, int(np.prod(self.event_shape)))

  def build(self, in_shape=None, generator=None):
    self.table.build(generator)
    return self.event_shape

  def forward(self, y):
    out = self.table(_to_indices(torch.as_tensor(y)))
    return out.reshape((out.shape[0],) + self.event_shape)


class ProjectionEmbedding(Embedder):
  """A Dense projection of the (one-hot or soft) label vector to
  `event_shape`; int labels become one-hot first."""

  def __init__(self, n_classes: int, event_shape: Sequence[int] = (),
               activation: Optional[Callable] = None, use_bias: bool = True):
    super().__init__(n_classes, event_shape)
    self.activation = activation
    self.proj = Dense(int(np.prod(self.event_shape)), use_bias=use_bias,
                      bare=True)

  def build(self, in_shape=None, generator=None):
    self.proj.build((self.n_classes,), generator)
    return self.event_shape

  def forward(self, y):
    if y.ndim == 1:
      y = F.one_hot(y.to(torch.int64), self.n_classes).to(torch.float32)
    out = get_activation(self.activation)(self.proj(y))
    return out.reshape((out.shape[0],) + self.event_shape)


class SequentialEmbedding(Embedder):
  """A lookup to `embedding_dim`, then a Dense projection to `event_shape`
  (the ConditionalGAN recipe)."""

  def __init__(self, n_classes: int, event_shape: Sequence[int] = (),
               embedding_dim: int = 100,
               activation: Optional[Callable] = None, use_bias: bool = True):
    super().__init__(n_classes, event_shape)
    self.activation = activation
    self.table = _Table(self.n_classes, int(embedding_dim))
    self.proj = Dense(int(np.prod(self.event_shape)), use_bias=use_bias,
                      bare=True)

  def build(self, in_shape=None, generator=None):
    self.table.build(generator)
    self.proj.build((self.table.features,), generator)
    return self.event_shape

  def forward(self, y):
    h = self.table(_to_indices(torch.as_tensor(y)))
    out = get_activation(self.activation)(self.proj(h))
    return out.reshape((out.shape[0],) + self.event_shape)


all_embedder = dict(repetition=RepetitionEmbedding,
                    projection=ProjectionEmbedding,
                    dictionary=DictionaryEmbedding,
                    sequential=SequentialEmbedding,
                    identity=IdentityEmbedding)


def get_embedding(method: str):
  """An embedder class by name; a prefix of a name resolves to it."""
  method = str(method).strip().lower()
  for name, cls in all_embedder.items():
    if method == name or method in name:
      return cls
  raise KeyError(f"no conditional embedding method {method!r}; "
                 f"supported: {sorted(all_embedder)}")
