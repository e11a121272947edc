"""Similarity and metric-learning losses and regularizers (PyTorch port of
``odin_tpu/backend/losses.py``): contrastive and triplet losses, cosine
scoring, the class-prior-weighted ("Bayes") cross-entropy and the Jacobian
and correntropy regularizers.

They keep the JAX package's documented semantics, with its fixes of the
original TF1 code: ``triplet_loss`` is FaceNet's (the original was an empty
stub), ``cosine_similarity`` scores every enrollment against every test
vector, and ``correntropy_regularize`` has the minus sign in its exponent.
Each runs in float32 on the device of a tensor argument (the card for an
array)."""
from __future__ import annotations

import math

import torch

from odin_tpu_torch.device import as_tensor, device_of

__all__ = [
    "contrastive_loss",
    "triplet_loss",
    "cosine_similarity",
    "bayes_crossentropy",
    "bayes_binary_crossentropy",
    "jacobian_regularize",
    "correntropy_regularize",
]

EPS = 1e-8


def _f32(x, device) -> torch.Tensor:
  return as_tensor(x, device, torch.float32)


def contrastive_loss(y_true, y_pred, margin: float = 1.0,
                     device=None) -> torch.Tensor:
  """Hadsell-Chopra-LeCun contrastive loss: `y_true` in {0, 1} marks
  similar pairs and `y_pred` is the pair's embedding distance ``d``; the
  mean of ``y d² + (1 - y) max(margin - d, 0)²``."""
  device = device_of(y_true, y_pred, device=device)
  y_true, d = _f32(y_true, device), _f32(y_pred, device)
  return torch.mean(y_true * torch.square(d) + (1.0 - y_true) *
                    torch.square(torch.clamp(margin - d, min=0.0)))


def triplet_loss(anchor, positive, negative, margin: float = 1.0,
                 device=None) -> torch.Tensor:
  """FaceNet's triplet loss, the mean of
  ``max(0, |a - p|² - |a - n|² + margin)`` over the last axis."""
  device = device_of(anchor, positive, negative, device=device)
  a, p, n = (as_tensor(t, device) for t in (anchor, positive, negative))
  ap = torch.sum(torch.square(a - p), dim=-1)
  an = torch.sum(torch.square(a - n), dim=-1)
  return torch.mean(torch.clamp(ap - an + margin, min=0.0))


def cosine_similarity(y_true, y_pred, unit_norm: bool = True,
                      one_vs_all: bool = True, device=None) -> torch.Tensor:
  """Cosine scores of enrollment rows `y_true` against test rows
  `y_pred`: the (n_enroll, n_test) matrix with `one_vs_all`, else the
  per-pair distance ``1 - <t, p>`` of shape (n, 1).  `unit_norm` divides
  each row by ``max(|row|, 1e-8)`` first."""
  device = device_of(y_true, y_pred, device=device)
  t, p = _f32(y_true, device), _f32(y_pred, device)
  if unit_norm:
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                        min=EPS)
    p = p / torch.clamp(torch.linalg.vector_norm(p, dim=-1, keepdim=True),
                        min=EPS)
  if one_vs_all:
    return t @ p.T
  return 1.0 - torch.sum(t * p, dim=-1, keepdim=True)


def bayes_crossentropy(y_true, y_pred, nb_classes: int | None = None,
                       device=None) -> torch.Tensor:
  """Class-prior-weighted cross-entropy: each class's log-likelihood is
  divided by the class's share of the batch (clipped to [1e-8, 1 - 1e-8]),
  so rare classes weigh as much as frequent ones; the sum over classes is
  scaled by ``1 / nb_classes`` and averaged over the batch.

  `y_pred` holds probabilities; a 1-D or single-column one is binary
  ``[1 - p, p]``.  Integer (1-D) `y_true` is one-hot encoded, which needs
  `nb_classes`."""
  device = device_of(y_true, y_pred, device=device)
  y_pred = _f32(y_pred, device)
  y_true = as_tensor(y_true, device)
  if y_pred.ndim == 1 or y_pred.shape[-1] == 1:
    if y_pred.ndim == 1:
      y_pred = y_pred[:, None]
    y_pred = torch.cat([1.0 - y_pred, y_pred], dim=-1)
  if y_true.ndim == 1:
    if nb_classes is None:
      raise ValueError("y_true is not one-hot encoded: provide nb_classes")
    y_true = torch.nn.functional.one_hot(y_true.long(), nb_classes)
  elif nb_classes is None:
    nb_classes = y_true.shape[-1]
  y_true = y_true.float()
  y_pred = torch.clamp(y_pred, EPS, 1.0 - EPS)
  prior = torch.sum(y_true, dim=0)
  prior = torch.clamp(prior / torch.clamp(torch.sum(prior), min=EPS), EPS,
                      1.0 - EPS)
  loss = -torch.sum(y_true * torch.log(y_pred) / prior, dim=-1) / nb_classes
  return torch.mean(loss)


def bayes_binary_crossentropy(y_true, y_pred, device=None) -> torch.Tensor:
  """The binary case of :func:`bayes_crossentropy`: `y_pred` holds
  ``p(y = 1)``, `y_true` 0/1 labels."""
  device = device_of(y_true, y_pred, device=device)
  y_pred = _f32(y_pred, device)
  if y_pred.ndim == 1:
    y_pred = y_pred[:, None]
  y_pred = torch.cat([1.0 - y_pred, y_pred], dim=-1)
  y_true = torch.nn.functional.one_hot(as_tensor(y_true, device).long(), 2)
  return bayes_crossentropy(y_true, y_pred, nb_classes=2)


def jacobian_regularize(hidden, params, device=None) -> torch.Tensor:
  """The contractive autoencoder's penalty for a sigmoid hidden layer: with
  ``h' = h (1 - h)``, the squared Frobenius norm of the Jacobian
  ``J_ij = h'_j W_ij``, summed and divided by the batch size.

  `hidden` is the (batch, n_hidden) activations; `params` is the layer's
  (n_in, n_hidden) matrix in the JAX package's layout, flax's Dense
  kernel.  A torch ``Linear.weight`` (and the port's ``Dense.weight``) is
  (n_hidden, n_in), its transpose: pass ``weight.T``."""
  device = device_of(hidden, params, device=device)
  h, w = _f32(hidden, device), _f32(params, device)
  hp = h * (1.0 - h)                        # (B, H)
  jac = hp[:, None, :] * w[None, :, :]      # (B, D, H)
  return torch.sum(torch.square(jac)) / h.shape[0]


def correntropy_regularize(x, sigma: float = 1.0,
                           device=None) -> torch.Tensor:
  """The correntropy-induced regularizer
  ``-sum_j mean_i exp(-x_ij² / sigma) / sqrt(2 pi sigma)``."""
  x = _f32(x, device_of(x, device=device))
  return (-torch.sum(torch.mean(torch.exp(-torch.square(x) / sigma), dim=0))
          / math.sqrt(2.0 * math.pi * sigma))
