"""Attention layers (PyTorch port of ``odin_tpu/networks/attention.py``).

The reference's flag algebra (``AttentionMechanism``) maps to the fields of
one ``Attention`` module:

* ``score``: 'dot' | 'additive' | 'cosine' | 'general' | 'location'
* ``position``: 'global' | 'local_m' (the trailing ``window`` keys) |
  'local_p' (a learned position picks a Gaussian window, Luong et al. 2015
  Eq. 10)
* ``align``: 'soft' | 'relaxed' (Gumbel-softmax sample at ``temperature``) |
  'hard' (one-hot categorical sample) with ``estimator`` 'st'
  (straight-through) or 'reinforce' (DiCE magic box)

The sampling alignments draw from an explicit ``torch.Generator`` passed to
the call, in place of flax's 'sample' rng stream.  ``MultiHeadAttention``
reproduces flax's ``MultiHeadDotProductAttention`` as the JAX wrapper uses
it; with ``flash=True`` its attention runs the flash attention kernel K2
(``ops/flash_attention.py``).  As elsewhere in the port, every layer has
``build(in_shape, generator)`` (batch dim excluded) that creates its
parameters with flax's initialisers; the attention layers also take the
key's and value's shapes where they differ from the query's.
``MultiHeadAttention.build`` also takes ``device`` and, as the port's
other entry points, puts the layer on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from enum import IntFlag, auto
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from odin_tpu_torch.device import resolve_device
from odin_tpu_torch.networks.base import Dense, get_activation
from odin_tpu_torch.ops.flash_attention import (NEG_INF,
                                                dot_product_attention,
                                                flash_attention_fn)

__all__ = ["AttentionMechanism", "Attention", "SelfAttention",
           "GlobalAttention", "LocalPredictiveAttention",
           "MultiHeadAttention", "AttentionHeads", "create_attention_heads"]

Shape = Sequence[int]


class AttentionMechanism(IntFlag):
  """Flag set kept for API parity (reference ``attention_mechanism.py:92``)."""

  ScoreDot = auto()
  ScoreAdditive = auto()
  ScoreLocation = auto()
  ScoreGeneral = auto()
  ScoreCosine = auto()
  Global = auto()
  LocalM = auto()
  LocalP = auto()
  Self = auto()
  Cross = auto()
  Soft = auto()
  Relax = auto()
  Hard = auto()

  def to_fields(self) -> dict:
    """Flags -> ``Attention`` fields."""
    M = AttentionMechanism
    score = ("additive" if M.ScoreAdditive in self else
             "location" if M.ScoreLocation in self else
             "general" if M.ScoreGeneral in self else
             "cosine" if M.ScoreCosine in self else "dot")
    position = ("local_m" if M.LocalM in self else
                "local_p" if M.LocalP in self else "global")
    align = ("hard" if M.Hard in self else
             "relaxed" if M.Relax in self else "soft")
    return dict(score=score, position=position, align=align)


def _dense(units: int, in_width: int, generator) -> Dense:
  layer = Dense(units, bare=True)  # flax's own nn.Dense
  layer.build((in_width,), generator)
  return layer


class Attention(nn.Module):
  """Attention over (query, key, value) with the full reference algebra.

  ``forward(q, k=None, v=None, mask=None, training=False, generator=None)``
  with k and v defaulting to q (self-attention) returns (context, weights);
  for 'hard' and 'relaxed' alignment ``weights`` is the (differentiable
  surrogate of the) sample drawn from ``generator``.  ``causal`` is
  aligned bottom-right (``np.tril(k=Tk - Tq)``), unlike flash attention's.
  """

  def __init__(self, units: Optional[int] = None, score: str = "dot",
               position: str = "global", align: str = "soft",
               estimator: str = "st", window: int = 8, causal: bool = False,
               temperature: float = 1.0, n_mcmc: int = 1):
    super().__init__()
    self.units = units
    self.score = score
    self.position = position
    self.align = align
    self.estimator = estimator
    self.window = int(window)
    self.causal = bool(causal)
    self.temperature = float(temperature)
    self.n_mcmc = n_mcmc  # kept for reference sample_shape parity

  def build(self, q_shape: Shape, generator=None, k_shape: Shape = None,
            v_shape: Shape = None) -> Shape:
    """Creates the parameters; flax's ``position`` Dense is
    ``position_proj`` here, since ``position`` names the mode."""
    k_shape = q_shape if k_shape is None else k_shape
    v_shape = k_shape if v_shape is None else v_shape
    qw, kw = int(q_shape[-1]), int(k_shape[-1])
    d = self.units or qw
    if self.units is not None:
      self.q_proj = _dense(d, qw, generator)
      self.k_proj = _dense(d, kw, generator)
      qw = kw = d
    if self.position == "local_p":
      self.pos_hidden = _dense(d, qw, generator)
      self.position_proj = _dense(1, d, generator)
    if self.score == "general":
      self.general_proj = _dense(kw, qw, generator)
    elif self.score == "additive":
      self.w_add = _dense(d, qw, generator)
      self.u_add = _dense(d, kw, generator)
      self.v_add = nn.Parameter(
          torch.randn(d, generator=generator) * 0.02)
    elif self.score == "location":
      self.loc = _dense(1, qw, generator)
    return tuple(q_shape[:-1]) + (int(v_shape[-1]),)

  def _logits(self, q, k, d):
    """Score every query step against every key step -> (B, Tq, Tv)."""
    if self.score == "dot":
      return torch.einsum("btd,bsd->bts", q, k) / np.sqrt(d)
    if self.score == "general":
      qg = self.general_proj(q)
      return torch.einsum("btd,bsd->bts", qg, k) / np.sqrt(k.shape[-1])
    if self.score == "cosine":
      qn = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-9)
      kn = k / k.norm(dim=-1, keepdim=True).clamp_min(1e-9)
      return torch.einsum("btd,bsd->bts", qn, kn)
    if self.score == "additive":
      h = torch.tanh(self.w_add(q)[:, :, None, :] +
                     self.u_add(k)[:, None, :, :])
      return torch.einsum("btsd,d->bts", h, self.v_add)
    if self.score == "location":
      return self.loc(q).expand(q.shape[:2] + (k.shape[1],))
    raise ValueError(f"unknown score '{self.score}'")

  def forward(self, q, k=None, v=None, mask=None, training: bool = False,
              generator: Optional[torch.Generator] = None):
    k = q if k is None else k
    v = k if v is None else v
    d = self.units or q.shape[-1]
    if self.units is not None:
      q = self.q_proj(q)
      k = self.k_proj(k)
    # -- positioning ---------------------------------------------------------
    gauss = None
    if self.position == "local_m":
      w = min(self.window, k.shape[1])
      k, v = k[:, -w:], v[:, -w:]
      if mask is not None:
        mask = mask[..., -w:]
    elif self.position == "local_p":
      S = k.shape[1]
      p = torch.sigmoid(self.position_proj(torch.tanh(self.pos_hidden(q))))[
          ..., 0] * S                                        # (B, Tq)
      positions = torch.arange(S, device=q.device)[None, None, :]
      gauss = torch.exp(-0.5 * ((positions - p[..., None]) /
                                (self.window / 2.0)) ** 2)   # (B, Tq, S)
    elif self.position != "global":
      raise ValueError(f"unknown position '{self.position}'")
    # -- scoring -------------------------------------------------------------
    logits = self._logits(q, k, d)
    if gauss is not None:
      logits = logits + torch.log(gauss.clamp_min(1e-20))
    if self.causal:
      t, s = logits.shape[-2], logits.shape[-1]
      causal = torch.from_numpy(np.tril(np.ones((t, s), bool), k=s - t)).to(
          logits.device)
      logits = torch.where(causal[None], logits, NEG_INF)
    if mask is not None:
      logits = torch.where(mask.bool(), logits, NEG_INF)
    # -- alignment -----------------------------------------------------------
    soft = torch.softmax(logits / self.temperature, dim=-1)
    if self.align == "soft":
      weights = soft
    elif self.align in ("relaxed", "hard"):
      if generator is None:
        raise ValueError(f"align '{self.align}' samples: pass a "
                         "torch.Generator as `generator`")
      u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype,
                     device=logits.device).clamp_min(1e-20)
      g = -torch.log(-torch.log(u))
      if self.align == "relaxed":
        # Gumbel-softmax: reparameterised, gradients flow through the sample
        weights = torch.softmax((logits + g) / self.temperature, dim=-1)
      else:
        idx = torch.argmax(logits.detach() + g, dim=-1)  # Gumbel-max
        onehot = F.one_hot(idx, logits.shape[-1]).to(logits.dtype)
        if self.estimator == "st":
          # straight-through: forward one-hot, backward softmax
          weights = onehot + soft - soft.detach()
        elif self.estimator == "reinforce":
          # DiCE magic box: value == one-hot sample, gradient == REINFORCE
          logp = torch.gather(torch.log_softmax(logits, dim=-1), -1,
                              idx[..., None])                # (B, Tq, 1)
          weights = onehot * torch.exp(logp - logp.detach())
        else:
          raise ValueError(f"unknown estimator '{self.estimator}'")
    else:
      raise ValueError(f"unknown align '{self.align}'")
    context = torch.einsum("bts,bsd->btd", weights, v)
    return context, weights


class SelfAttention(nn.Module):
  """Reference ``attention.py:22``.  As in the JAX layer, ``mask`` is not
  passed on."""

  def __init__(self, units: Optional[int] = None, score: str = "dot",
               causal: bool = False):
    super().__init__()
    self.attn = Attention(units=units, score=score, causal=causal)

  def build(self, in_shape: Shape, generator=None) -> Shape:
    return self.attn.build(in_shape, generator)

  def forward(self, x, mask=None, training: bool = False):
    return self.attn(x, training=training)[0]


class GlobalAttention(nn.Module):
  """Full-window cross attention."""

  def __init__(self, units: Optional[int] = None, score: str = "dot"):
    super().__init__()
    self.attn = Attention(units=units, score=score)

  def build(self, q_shape: Shape, generator=None, k_shape: Shape = None,
            v_shape: Shape = None) -> Shape:
    return self.attn.build(q_shape, generator, k_shape, v_shape)

  def forward(self, q, k, v=None, mask=None, training: bool = False):
    return self.attn(q, k, v, mask=mask, training=training)[0]


class LocalPredictiveAttention(nn.Module):
  """Local-p attention (Luong et al.): a learned position predictor centres
  a Gaussian window over the keys."""

  def __init__(self, units: Optional[int] = None, window: int = 8):
    super().__init__()
    self.attn = Attention(units=units, position="local_p", window=window)

  def build(self, q_shape: Shape, generator=None, k_shape: Shape = None,
            v_shape: Shape = None) -> Shape:
    return self.attn.build(q_shape, generator, k_shape, v_shape)

  def forward(self, q, k, v=None, training: bool = False):
    return self.attn(q, k, v, training=training)[0]


class MultiHeadAttention(nn.Module):
  """flax's ``MultiHeadDotProductAttention`` as the JAX wrapper uses it:
  q, k and v projected to (num_heads, head_dim) with biases, attention,
  and the output projected back to q's width.  With ``flash=True`` the
  attention runs ``flash_attention_fn`` (K2 where no mask is given), else
  the plain ``dot_product_attention``.  ``query``, ``key``, ``value`` and
  ``out`` are ``Dense`` layers over the flattened heads (weight
  (H·D_h, F_in) and (F_out, H·D_h)); no dropout."""

  def __init__(self, num_heads: int = 4, qkv_features: Optional[int] = None,
               flash: bool = False):
    super().__init__()
    self.num_heads = int(num_heads)
    self.qkv_features = qkv_features
    self.flash = bool(flash)

  def build(self, q_shape: Shape, generator=None, k_shape: Shape = None,
            v_shape: Shape = None,
            device: Union[str, torch.device] = "cuda") -> Shape:
    """Creates the parameters from `generator` on the CPU (so that a seed
    gives the same weights on every device) and moves them to `device`."""
    k_shape = q_shape if k_shape is None else k_shape
    v_shape = k_shape if v_shape is None else v_shape
    device = resolve_device(device)
    features = int(q_shape[-1])
    qkv = int(self.qkv_features or features)
    if qkv % self.num_heads:
      raise ValueError(f"qkv_features {qkv} is not divisible by "
                       f"{self.num_heads} heads")
    self.query = _dense(qkv, features, generator)
    self.key = _dense(qkv, int(k_shape[-1]), generator)
    self.value = _dense(qkv, int(v_shape[-1]), generator)
    self.out = _dense(features, qkv, generator)
    self.to(device)
    return tuple(q_shape)

  @property
  def head_dim(self) -> int:
    return self.query.units // self.num_heads

  def forward(self, q, k=None, v=None, mask=None, training: bool = False):
    k = q if k is None else k
    v = k if v is None else v
    heads = (self.num_heads, self.head_dim)
    query = self.query(q).unflatten(-1, heads)
    key = self.key(k).unflatten(-1, heads)
    value = self.value(v).unflatten(-1, heads)
    if self.flash:
      x = flash_attention_fn(query, key, value, mask=mask,
                             deterministic=not training)
    else:
      x = dot_product_attention(query, key, value, mask=mask)
    return self.out(x.flatten(-2))


class AttentionHeads(nn.Module):
  """Multi-head projection ``(B, T, d) -> (H, B, T, d)`` (reference
  ``create_attention_heads``, ``attention_mechanism.py:69``): ``depth``
  stacked Dense(d·H) layers, each followed by the activation, then split
  into heads."""

  def __init__(self, num_heads: int = 2, depth: int = 1,
               use_bias: bool = True, activation: Any = "relu"):
    super().__init__()
    self.num_heads = int(num_heads)
    self.depth = int(depth)
    self.use_bias = bool(use_bias)
    self.activation = activation

  def _projects(self) -> bool:
    return self.num_heads > 1 and self.depth > 0

  def build(self, in_shape: Shape, generator=None) -> Shape:
    d = int(in_shape[-1])
    if not self._projects():
      return ((1,) if self.num_heads > 1 else ()) + tuple(in_shape)
    width = d
    for i in range(self.depth):
      layer = Dense(d * self.num_heads, use_bias=self.use_bias, bare=True)
      layer.build((width,), generator)
      self.add_module(f"head_proj_{i}", layer)
      width = d * self.num_heads
    return (self.num_heads,) + tuple(in_shape)

  def forward(self, x, training: bool = False):
    if not self._projects():
      return x[None] if self.num_heads > 1 else x
    d = x.shape[-1]
    h = x
    act = get_activation(self.activation)
    for i in range(self.depth):
      h = act(getattr(self, f"head_proj_{i}")(h))
    # (B, T, d*H) -> (H, B, T, d)
    return torch.movedim(h.unflatten(-1, (self.num_heads, d)), -2, 0)


def create_attention_heads(input_dim: int, num_heads: int = 2,
                           depth: int = 1, use_bias: bool = True,
                           activation: Any = "relu") -> AttentionHeads:
  """Factory form (reference ``attention_mechanism.py:69``); ``input_dim``
  is kept for signature parity."""
  del input_dim
  return AttentionHeads(num_heads=num_heads, depth=depth,
                        use_bias=use_bias, activation=activation)
