"""VI utilities of the port (PyTorch port of ``odin_tpu/bay/vi/utils.py``):
``permute_dims``, ``discretizing`` and the semi-supervised input helpers.

``discretizing`` with ``strategy='uniform'`` is scikit-learn 1.9's
``KBinsDiscretizer(encode='ordinal', strategy='uniform')`` bin for bin:
the edges are ``np.linspace(min, max, n_bins + 1)`` in the column's dtype
(computed on the host from the column's extremes) and the bin is
``searchsorted(edges[1:-1], x, side='right')``, on the device of x.  The
'quantile', 'kmeans' and 'gmm' strategies are in ``discretizers``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from odin_tpu_torch.bay.vi.discretizers import (GaussianMixture, bins_of,
                                                kmeans_edges, quantile_edges)
from odin_tpu_torch.bay.vi.estimators import as_tensor, device_of

__all__ = [
    "permute_dims", "discretizing", "prepare_ssl_inputs", "split_ssl_inputs",
    "marginalize_categorical_labels",
]


def permute_dims(z: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
  """FactorVAE's Algorithm 1: shuffle each latent dimension independently
  along the batch axis of z (..., B, D): the argsort of (B, D) uniforms,
  drawn from `generator` or given as `uniforms`, gathers each column."""
  if uniforms is None:
    uniforms = torch.rand(tuple(z.shape[-2:]), generator=generator,
                          device=z.device)
  idx = torch.argsort(torch.as_tensor(uniforms, device=z.device), dim=0)
  return torch.take_along_dim(z, idx.expand(z.shape), dim=-2)


def _uniform_bins(col: torch.Tensor, n_bins: int):
  """One column's bins (int64) and its bin edges."""
  if not col.is_floating_point():
    col = col.to(torch.float64)
  lo, hi = (float(v) for v in torch.aminmax(col))
  if lo == hi:  # a constant column is one bin
    return (torch.zeros(col.shape, dtype=torch.int64, device=col.device),
            np.array([-np.inf, np.inf]))
  np_dtype = np.float32 if col.dtype == torch.float32 else np.float64
  edges = np.linspace(np_dtype(lo), np_dtype(hi), n_bins + 1)
  inner = torch.as_tensor(edges[1:-1]).to(col.device)
  return torch.searchsorted(inner, col.contiguous(), right=True), edges


def _column_bins(col: torch.Tensor, n_bins: int, strategy: str):
  """One column's bins (int64) and its model: the bin edges, or for 'gmm'
  the mixture's means, variances and weights."""
  if strategy == "uniform":
    return _uniform_bins(col, n_bins)
  if not col.is_floating_point():
    col = col.to(torch.float64)
  if strategy == "gmm":
    gmm = GaussianMixture(n_components=n_bins, random_state=1)
    labels = gmm.fit_predict(col)
    # relabelled by the order of the component means, as the JAX package
    order = torch.argsort(gmm.means_, stable=True)
    remap = torch.empty_like(order)
    remap[order] = torch.arange(len(order), device=order.device)
    return remap[labels], gmm.model()
  lo, hi = (float(v) for v in torch.aminmax(col))
  if lo == hi:  # a constant column is one bin
    return (torch.zeros(col.shape, dtype=torch.int64, device=col.device),
            np.array([-np.inf, np.inf]))
  edges = (quantile_edges if strategy == "quantile" else kmeans_edges)(
      col, n_bins)
  return bins_of(col, edges), edges.cpu().numpy()


def discretizing(*factors,
                 independent: bool = True,
                 n_bins: Union[int, Sequence[int]] = 5,
                 strategy: str = "uniform",
                 return_model: bool = False,
                 device=None):
  """Discretize each column of each factor array (N, ...) into `n_bins`
  bins (int64, on the device of the input, or `device`; the card for an
  array unless asked for the CPU).  `strategy` 'uniform' (equal widths),
  'quantile', 'kmeans' (scikit-learn's ``KBinsDiscretizer``) or 'gmm' (a
  one-feature ``GaussianMixture`` a column, the components numbered by
  their means).  `independent` is accepted for the JAX package's signature
  (columns are always binned apart).  With `return_model` each column's
  model comes back beside the bins: its bin edges, or for 'gmm' the
  mixture's means, variances and weights."""
  if strategy not in ("uniform", "quantile", "kmeans", "gmm"):
    raise ValueError(f"unknown discretizing strategy {strategy!r}")
  n_bins = int(n_bins)
  dev = device_of(*factors, device=device)
  outputs, models = [], []
  for f in factors:
    f = as_tensor(f, dev)
    shape = f.shape
    f2 = f.reshape(len(f), -1)
    cols, model = zip(*(_column_bins(f2[:, j], n_bins, strategy)
                        for j in range(f2.shape[1])))
    models.append(list(model))
    outputs.append(torch.stack(cols, -1).reshape(shape))
  out = outputs[0] if len(outputs) == 1 else outputs
  if return_model:
    return out, (models[0] if len(models) == 1 else models)
  return out


def prepare_ssl_inputs(inputs, mask=None, n_unsupervised_inputs: int = 1):
  """Split a batch into (x list, y list, mask)."""
  if not isinstance(inputs, (tuple, list)):
    inputs = [inputs]
  inputs = list(inputs)
  return inputs[:n_unsupervised_inputs], inputs[n_unsupervised_inputs:], mask


def split_ssl_inputs(x, y, mask):
  """Partition a semi-supervised batch into its labelled and unlabelled
  parts by a boolean mask: ((x[mask], y[mask]), (x[~mask],)); tensors stay
  on their device."""
  if isinstance(x, torch.Tensor):
    m = torch.as_tensor(mask, device=x.device).to(torch.bool).reshape(-1)
    y = torch.as_tensor(y, device=x.device)
    return (x[m], y[m]), (x[~m],)
  m = np.asarray(mask).astype(bool).ravel()
  x, y = np.asarray(x), np.asarray(y)
  return (x[m], y[m]), (x[~m],)


def marginalize_categorical_labels(x: torch.Tensor, n_classes: int,
                                   dtype: torch.dtype = torch.float32):
  """Repeat a batch once per class with every one-hot label, the M2
  marginalisation over an unobserved y: (x_tiled (B·K, ...), y_tiled
  (B·K, K)), grouped per example."""
  x = torch.as_tensor(x)
  b = x.shape[0]
  eye = torch.eye(n_classes, dtype=dtype, device=x.device)
  return torch.repeat_interleave(x, n_classes, dim=0), eye.repeat(b, 1)
