"""Downstream disentanglement scores of the port (PyTorch port of
``odin_tpu/bay/vi/downstream_metrics.py``): DCI, SAP, the beta-VAE score
and the FactorVAE score.

The estimators are the port's torch ones (``estimators.py``) on the device
of the representations.  The beta-VAE and FactorVAE scores draw their
factors, values and rows from a numpy ``RandomState(seed)`` in exactly the
JAX package's order, so the same pairs and batches are drawn; the gathers,
the |z1 - z2| means and the variance argmins run on the device.  With
``n_mcmc > 0`` a distribution's samples come from a ``torch.Generator``
seeded by the same ``rand.randint(int(1e8))`` draw that keys JAX's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from odin_tpu_torch.bay.vi.estimators import (
    GradientBoostingClassifier, LogisticRegression, StandardScaler,
    as_tensor, device_of, fit_l2_svc, svc_problems, train_test_split)

__all__ = [
    "importance_matrix", "disentanglement_score", "completeness_score",
    "dci_scores", "separated_attr_predictability", "beta_vae_score",
    "factor_vae_score",
]


def _is_distribution(x) -> bool:
  return not isinstance(x, (torch.Tensor, np.ndarray)) and hasattr(x, "mean")


def _representation(x, device=None) -> torch.Tensor:
  """A tensor or array as is, a distribution as its mean; on `device`, or
  where it lies (the card for an array unless asked for the CPU)."""
  if _is_distribution(x):
    x = x.mean()
  return as_tensor(x, device_of(x, device=device))


def _split(repr_train, factor_train, repr_test, factor_test, test_size,
           seed, device):
  repr_train = _representation(repr_train, device)
  dev = repr_train.device
  factor_train = as_tensor(factor_train, dev)
  if repr_test is None or factor_test is None:
    repr_train, repr_test, factor_train, factor_test = train_test_split(
        repr_train, factor_train, test_size=test_size, random_state=seed)
  else:
    repr_test = _representation(repr_test, dev)
    factor_test = as_tensor(factor_test, dev)
  return repr_train, factor_train, repr_test, factor_test


def importance_matrix(repr_train, factor_train, repr_test=None,
                      factor_test=None, test_size: float = 0.2, seed: int = 1,
                      n_estimators: int = 10, device=None,
                      **gbt_kwargs) -> Tuple[torch.Tensor, list, list]:
  """([n_latents, n_factors] gradient-boosted-tree importances, train
  accuracies, test accuracies); one ``GradientBoostingClassifier
  (n_estimators, random_state=seed)`` per factor, as the JAX package
  fits."""
  repr_train, factor_train, repr_test, factor_test = _split(
      repr_train, factor_train, repr_test, factor_test, test_size, seed,
      device)
  n_latents = repr_train.shape[1]
  n_factors = factor_train.shape[1]
  matrix = torch.zeros(n_latents, n_factors, dtype=torch.float64,
                       device=repr_train.device)
  train_acc, test_acc = [], []
  for j in range(n_factors):
    y = factor_train[:, j]
    if torch.unique(y).numel() < 2:
      train_acc.append(1.0)
      test_acc.append(1.0)
      continue
    model = GradientBoostingClassifier(n_estimators=n_estimators,
                                       random_state=seed, **gbt_kwargs)
    model.fit(repr_train, y)
    matrix[:, j] = torch.abs(model.feature_importances_)
    train_acc.append(model.score(repr_train, y))
    test_acc.append(model.score(repr_test, factor_test[:, j]))
  return matrix, train_acc, test_acc


def _entropy_normalized(p: torch.Tensor, dim: int) -> torch.Tensor:
  p = p / torch.clamp(p.sum(dim=dim, keepdim=True), min=1e-11)
  k = p.shape[dim]
  return -torch.sum(p * torch.log(p + 1e-11), dim=dim) / np.log(max(k, 2))


def disentanglement_score(importance, device=None) -> float:
  """1 - the entropy of each latent's factor distribution, weighted by the
  latent's share of the importance (Eastwood & Williams)."""
  importance = as_tensor(importance, device_of(importance, device=device)
                         ).to(torch.float64)
  per_code = 1.0 - _entropy_normalized(importance, dim=1)
  weights = importance.sum(1) / torch.clamp(importance.sum(), min=1e-11)
  return float(torch.sum(per_code * weights))


def completeness_score(importance, device=None) -> float:
  """1 - the entropy of each factor's latent distribution, weighted by the
  factor's share of the importance."""
  importance = as_tensor(importance, device_of(importance, device=device)
                         ).to(torch.float64)
  per_factor = 1.0 - _entropy_normalized(importance, dim=0)
  weights = importance.sum(0) / torch.clamp(importance.sum(), min=1e-11)
  return float(torch.sum(per_factor * weights))


def dci_scores(repr_train, factor_train, repr_test=None, factor_test=None,
               test_size: float = 0.2, seed: int = 1, **kwargs):
  """(disentanglement, completeness, informativeness)."""
  imp, _, test_acc = importance_matrix(repr_train, factor_train, repr_test,
                                       factor_test, test_size=test_size,
                                       seed=seed, **kwargs)
  return (disentanglement_score(imp), completeness_score(imp),
          float(np.mean(test_acc)))


def separated_attr_predictability(repr_train, factor_train, repr_test=None,
                                  factor_test=None, test_size: float = 0.2,
                                  continuous_factors: bool = False,
                                  seed: int = 1, max_iter: int = 100,
                                  device=None) -> float:
  """SAP (Kumar et al. 2018): the mean over factors of the gap between the
  two latents that predict it best.  Discrete factors: each latent alone,
  standardised (``StandardScaler``), into a ``LinearSVC(C=0.01,
  class_weight='balanced')``, scored by its test accuracy.  Every (latent,
  factor, class) problem is solved in one batched Newton iteration
  (``fit_l2_svc``; `max_iter` bounds its Newton steps)."""
  score = sap_matrix(repr_train, factor_train, repr_test, factor_test,
                     test_size, continuous_factors, seed, max_iter, device)
  top = torch.sort(score, dim=0).values
  return float(torch.mean(top[-1] - top[-2]))


def sap_matrix(repr_train, factor_train, repr_test=None, factor_test=None,
               test_size: float = 0.2, continuous_factors: bool = False,
               seed: int = 1, max_iter: int = 100,
               device=None) -> torch.Tensor:
  """SAP's [n_latents, n_factors] score matrix: each latent's test
  accuracy for each discrete factor (0 for a factor of one value), or the
  squared correlation for continuous factors."""
  repr_train, factor_train, repr_test, factor_test = _split(
      repr_train, factor_train, repr_test, factor_test, test_size, seed,
      device)
  dev = repr_train.device
  n_latents = repr_train.shape[1]
  n_factors = factor_train.shape[1]
  score = torch.zeros(n_latents, n_factors, dtype=torch.float64, device=dev)
  if continuous_factors:
    x = repr_train.to(torch.float64)
    y = factor_train.to(torch.float64)
    x = x - x.mean(0)
    y = y - y.mean(0)
    n = x.shape[0]
    cov = x.T @ y / (n - 1)
    var_x = (x * x).sum(0) / (n - 1)
    var_y = (y * y).sum(0) / (n - 1)
    score = cov ** 2 / torch.clamp(var_x[:, None] * var_y[None, :],
                                   min=1e-12)
  else:
    scaled = [StandardScaler().fit(repr_train[:, i:i + 1])
              for i in range(n_latents)]
    x_train = torch.cat([s.transform(repr_train[:, i:i + 1])
                         for i, s in enumerate(scaled)], 1).to(torch.float64)
    x_test = torch.cat([s.transform(repr_test[:, i:i + 1])
                        for i, s in enumerate(scaled)], 1).to(torch.float64)
    n = x_train.shape[0]
    ones = torch.ones(n, dtype=torch.float64, device=dev)
    fits = []  # (factor, classes, problems' rows in the batch)
    Xs, Ys, Cs = [], [], []
    for j in range(n_factors):
      classes, yi = torch.unique(factor_train[:, j], return_inverse=True)
      K = classes.numel()
      if K < 2:
        continue
      Y, Cw = svc_problems(yi, K, 0.01, "balanced")  # (P, n) each
      first = sum(len(y) for y in Ys)
      for i in range(n_latents):
        Xs.append(torch.stack([x_train[:, i], ones], 1)[None].expand(
            Y.shape[0], n, 2))
        Ys.append(Y)
        Cs.append(Cw)
      fits.append((j, classes, first, Y.shape[0]))
    if fits:
      w = fit_l2_svc(torch.cat(Xs), torch.cat(Ys), torch.cat(Cs),
                     max_iter=max_iter)
      for j, classes, first, P in fits:
        for i in range(n_latents):
          wi = w[first + i * P:first + (i + 1) * P]  # (P, 2)
          raw = x_test[:, i:i + 1] * wi[:, 0] + wi[:, 1]  # (n_test, P)
          pick = (raw[:, 0] > 0).long() if classes.numel() == 2 else \
              torch.argmax(raw, 1)
          score[i, j] = (classes[pick] == factor_test[:, j]).to(
              torch.float64).mean()
  return score


def _flat_buckets(factors: np.ndarray, min_count: int = 1):
  """Per factor (rows sorted by value, offsets, counts) of the values
  holding at least `min_count` rows: ``order[offsets[v]:offsets[v] +
  counts[v]]`` are the rows of the v-th such value (the JAX package's
  tables, on the host)."""
  tables = []
  for j in range(factors.shape[1]):
    col = factors[:, j]
    vals, counts = np.unique(col, return_counts=True)
    order = np.argsort(col, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    keep = counts >= min_count
    tables.append((order, offsets[keep], counts[keep]))
  return tables


def _representation_matrix(representations, n_mcmc, rand, device):
  """(samples, X): X the point representation (a distribution's mean) on
  the device; samples None, or the (n_mcmc, N, D) draws of a distribution
  from a generator seeded by one ``rand.randint(int(1e8))``, as the JAX
  package keys its draw."""
  mean = _representation(representations, device)
  if n_mcmc > 0 and _is_distribution(representations) and hasattr(
      representations, "sample"):
    generator = torch.Generator(mean.device).manual_seed(
        int(rand.randint(int(1e8))))
    samples = representations.sample((n_mcmc,), generator=generator)
    return as_tensor(samples, mean.device), mean
  return None, mean


_GATHER_CHUNK = 512  # the JAX package's draws come in chunks of this many


def _factors_int(factors) -> np.ndarray:
  factors = np.asarray(factors.cpu() if isinstance(factors, torch.Tensor)
                       else factors)
  if factors.dtype.kind == "f":
    if not np.allclose(factors, np.round(factors)):
      raise ValueError("the score requires discrete factors")
  return factors.astype(np.int64)


def beta_vae_score(representations, factors, n_mcmc: int = 10,
                   batch_size: int = 10, n_samples: int = 10000,
                   n_eval_samples: int = 0, seed: int = 1,
                   return_model: bool = False, verbose: bool = False,
                   device=None):
  """The beta-VAE metric (Higgins et al.): a logistic regression from the
  mean |z1 - z2| of `batch_size` pairs sharing one factor's value to that
  factor, scored by its accuracy on the training votes, or with
  `n_eval_samples` > 0 on that many fresh ones (disentanglement_lib's
  protocol)."""
  rand = np.random.RandomState(seed)
  factors = _factors_int(factors)
  n_factors = factors.shape[1]
  mcmc, X = _representation_matrix(representations, n_mcmc, rand, device)
  dev = X.device
  tables = _flat_buckets(factors, min_count=2)
  eligible = np.array([len(t[2]) > 0 for t in tables])

  def pair_features(n):
    """(features, labels) of `n` factor draws, factor-major rows: the
    draws on the host in the JAX package's order, the gathers and means
    on the device."""
    fs = rand.randint(n_factors, size=n)
    fs = fs[eligible[fs]]
    ids1, ids2, l1s, l2s = [], [], [], []
    for f in range(n_factors):
      m = int(np.sum(fs == f))
      if m == 0:
        continue
      order, offsets, counts = tables[f]
      for c0 in range(0, m, _GATHER_CHUNK):
        cm = min(_GATHER_CHUNK, m - c0)
        vs = rand.randint(len(counts), size=(cm, batch_size))
        c = counts[vs]
        r1 = (rand.random_sample((cm, batch_size)) * c).astype(np.int64)
        r2 = (rand.random_sample((cm, batch_size)) * (c - 1)).astype(np.int64)
        r2 += (r2 >= r1)
        ids1.append(order[offsets[vs] + r1])
        ids2.append(order[offsets[vs] + r2])
        if mcmc is not None:
          l1s.append(rand.randint(n_mcmc, size=(cm, 1)))
          l2s.append(rand.randint(n_mcmc, size=(cm, 1)))
    labels = torch.as_tensor(np.sort(fs, kind="stable"), device=dev)
    if not ids1:
      return torch.zeros(0, X.shape[-1], dtype=X.dtype, device=dev), labels
    i1 = torch.as_tensor(np.concatenate(ids1), device=dev)
    i2 = torch.as_tensor(np.concatenate(ids2), device=dev)
    if mcmc is None:
      z1, z2 = X[i1], X[i2]
    else:
      z1 = mcmc[torch.as_tensor(np.concatenate(l1s), device=dev), i1]
      z2 = mcmc[torch.as_tensor(np.concatenate(l2s), device=dev), i2]
    return torch.mean(torch.abs(z1 - z2), dim=1), labels

  feats, labels = pair_features(n_samples)
  if torch.unique(labels).numel() < 2:
    # every drawn factor degenerate but one: trivially separable
    return (1.0, None) if return_model else 1.0
  model = LogisticRegression().fit(feats, labels)
  if n_eval_samples > 0:
    feats, labels = pair_features(n_eval_samples)
  score = model.score(feats, labels)
  return (score, model) if return_model else score


def factor_vae_score(representations, factors, n_mcmc: int = 10,
                     batch_size: int = 256, n_samples: int = 10000,
                     n_eval_samples: int = 0, seed: int = 1,
                     return_model: bool = False,
                     prune_threshold: float = 1e-6,
                     prune_scale: Optional[str] = None,
                     verbose: bool = False, device=None):
  """The FactorVAE metric (Kim & Mnih): the majority vote, per factor, of
  the latent with the least variance (over the representations' empirical
  variance) in batches sharing one value of that factor.  `prune_scale`
  says whether `prune_threshold` cuts the latents' std ('std',
  disentanglement_lib's) or variance ('var'); None picks 'std' at 1e-3 and
  above.  `n_eval_samples` > 0 scores fresh votes with the training votes'
  majority labels."""
  rand = np.random.RandomState(seed)
  factors = _factors_int(factors)
  n_factors = factors.shape[1]
  mcmc, X_all = _representation_matrix(representations, n_mcmc, rand, device)
  dev = X_all.device
  n_latents = X_all.shape[1]
  global_var = torch.var(X_all.to(torch.float64), dim=0, correction=1)
  if prune_scale is None:
    prune_scale = "std" if prune_threshold >= 1e-3 else "var"
  if prune_scale == "std":
    active = torch.sqrt(global_var) >= prune_threshold
  elif prune_scale == "var":
    active = global_var > prune_threshold
  else:
    raise ValueError(f"prune_scale must be 'std'|'var', got {prune_scale}")
  active_idx = torch.nonzero(active).reshape(-1)
  tables = _flat_buckets(factors, min_count=2)
  eligible = np.array([len(t[2]) > 0 for t in tables])

  def vote_matrix(n):
    fs = rand.randint(n_factors, size=n)
    fs = fs[eligible[fs]]
    ids, layers, rows = [], [], []
    for f in range(n_factors):
      m = int(np.sum(fs == f))
      if m == 0:
        continue
      order, offsets, counts = tables[f]
      for c0 in range(0, m, _GATHER_CHUNK):
        cm = min(_GATHER_CHUNK, m - c0)
        vs = rand.randint(len(counts), size=cm)
        c = counts[vs][:, None]
        r = (rand.random_sample((cm, batch_size)) * c).astype(np.int64)
        ids.append(order[offsets[vs][:, None] + r])
        if mcmc is not None:
          layers.append(rand.randint(n_mcmc, size=(cm, 1)))
        rows.append(np.full(cm, f))
    votes = torch.zeros(n_factors * n_latents, dtype=torch.int64, device=dev)
    if not ids:
      return votes.reshape(n_factors, n_latents)
    ids = torch.as_tensor(np.concatenate(ids), device=dev)
    rows = torch.as_tensor(np.concatenate(rows), device=dev)
    if layers:
      layers = torch.as_tensor(np.concatenate(layers), device=dev)
    for c0 in range(0, len(ids), 4 * _GATHER_CHUNK):
      sl = slice(c0, c0 + 4 * _GATHER_CHUNK)
      obs = X_all[ids[sl]] if mcmc is None else mcmc[layers[sl], ids[sl]]
      local_var = torch.var(obs.to(torch.float64), dim=1, correction=1)
      if len(active_idx):
        j = active_idx[torch.argmin(local_var[:, active_idx] /
                                    global_var[active_idx], dim=1)]
      else:
        j = torch.zeros(obs.shape[0], dtype=torch.int64, device=dev)
      votes.index_add_(0, rows[sl] * n_latents + j,
                       torch.ones_like(j))
    return votes.reshape(n_factors, n_latents)

  votes = vote_matrix(n_samples)
  true_labels = torch.argmax(votes, dim=0)
  if n_eval_samples > 0:
    votes = vote_matrix(n_eval_samples)
  hits = votes[true_labels, torch.arange(n_latents, device=dev)]
  score = float(hits.sum()) / max(int(votes.sum()), 1)
  return (score, true_labels) if return_model else score
