"""Naive Bayes of the port, in closed form on the device of its inputs:
scikit-learn 1.9's ``BernoulliNB``, ``CategoricalNB`` and ``MultinomialNB``
with ``alpha``, ``fit_prior`` and ``class_prior``, in float64 as
scikit-learn fits them, and ``fast_naive_bayes``, the JAX package's
dispatcher (``odin_tpu/ml/cluster.py``)."""
from __future__ import annotations

import math

import torch

from odin_tpu_torch.device import as_tensor, device_of

__all__ = ["BernoulliNB", "CategoricalNB", "MultinomialNB",
           "fast_naive_bayes"]


class _NaiveBayes:
  """The shared fit (class counts, the prior) and prediction."""

  def __init__(self, alpha: float = 1.0, fit_prior: bool = True,
               class_prior=None, device=None):
    self.alpha = float(alpha)
    self.fit_prior = bool(fit_prior)
    self.class_prior = class_prior
    self.device = device

  def _prepare(self, X, y):
    X = as_tensor(X, device_of(X, y, device=self.device))
    y = as_tensor(y, X.device).reshape(-1)
    self.classes_, yi = torch.unique(y, return_inverse=True)
    k = self.classes_.numel()
    Y = torch.nn.functional.one_hot(yi, k).to(torch.float64)
    self.class_count_ = Y.sum(0)
    if self.class_prior is not None:
      prior = as_tensor(self.class_prior, X.device, torch.float64)
      if prior.numel() != k:
        raise ValueError("Number of priors must match number of classes.")
      self.class_log_prior_ = torch.log(prior)
    elif self.fit_prior:
      self.class_log_prior_ = (torch.log(self.class_count_) -
                               torch.log(self.class_count_.sum()))
    else:
      self.class_log_prior_ = torch.full((k,), -math.log(k),
                                         dtype=torch.float64, device=X.device)
    return X, Y

  def predict_joint_log_proba(self, X) -> torch.Tensor:
    X = as_tensor(X, self.classes_.device)
    return self._joint_log_likelihood(X)

  def predict_log_proba(self, X) -> torch.Tensor:
    jll = self.predict_joint_log_proba(X)
    return jll - torch.logsumexp(jll, dim=1, keepdim=True)

  def predict_proba(self, X) -> torch.Tensor:
    return torch.exp(self.predict_log_proba(X))

  def predict(self, X) -> torch.Tensor:
    return self.classes_[torch.argmax(self.predict_joint_log_proba(X), 1)]

  def score(self, X, y) -> float:
    y = as_tensor(y, self.classes_.device).reshape(-1)
    return float((self.predict(X) == y).to(torch.float64).mean())


class MultinomialNB(_NaiveBayes):
  """Counts of each feature in each class, smoothed by `alpha`."""

  def fit(self, X, y) -> "MultinomialNB":
    X, Y = self._prepare(X, y)
    if bool((X < 0).any()):
      raise ValueError("Negative values in data passed to MultinomialNB "
                       "(input X)")
    self.feature_count_ = Y.T @ X.to(torch.float64)
    smoothed = self.feature_count_ + self.alpha
    self.feature_log_prob_ = (torch.log(smoothed) -
                              torch.log(smoothed.sum(1, keepdim=True)))
    return self

  def _joint_log_likelihood(self, X):
    return X.to(torch.float64) @ self.feature_log_prob_.T + \
        self.class_log_prior_


class BernoulliNB(_NaiveBayes):
  """Features binarised at 0 (``binarize=0.0``), each a Bernoulli in each
  class, smoothed by `alpha`."""

  def __init__(self, alpha: float = 1.0, binarize: float = 0.0,
               fit_prior: bool = True, class_prior=None, device=None):
    super().__init__(alpha, fit_prior, class_prior, device)
    self.binarize = binarize

  def _binary(self, X):
    X = X.to(torch.float64)
    return X if self.binarize is None else (X > self.binarize).to(
        torch.float64)

  def fit(self, X, y) -> "BernoulliNB":
    X, Y = self._prepare(X, y)
    self.feature_count_ = Y.T @ self._binary(X)
    smoothed_cc = self.class_count_ + 2.0 * self.alpha
    self.feature_log_prob_ = (torch.log(self.feature_count_ + self.alpha) -
                              torch.log(smoothed_cc)[:, None])
    return self

  def _joint_log_likelihood(self, X):
    X = self._binary(X)
    neg = torch.log(1.0 - torch.exp(self.feature_log_prob_))
    return (X @ (self.feature_log_prob_ - neg).T + neg.sum(1) +
            self.class_log_prior_)


class CategoricalNB(_NaiveBayes):
  """Each feature a categorical over 0..max in each class (the categories
  counted from the data, ``min_categories=None``), smoothed by `alpha`."""

  def fit(self, X, y) -> "CategoricalNB":
    X, Y = self._prepare(X, y)
    if X.is_floating_point() and not bool((X == torch.round(X)).all()):
      raise ValueError("CategoricalNB takes integer categories")
    X = X.to(torch.int64)
    if bool((X < 0).any()):
      raise ValueError("Negative values in data passed to CategoricalNB "
                       "(input X)")
    self.n_categories_ = (X.max(0).values + 1).tolist()
    self.category_count_, self.feature_log_prob_ = [], []
    for j, n_cat in enumerate(self.n_categories_):
      count = Y.T @ torch.nn.functional.one_hot(X[:, j], n_cat).to(
          torch.float64)
      smoothed = count + self.alpha
      self.category_count_.append(count)
      self.feature_log_prob_.append(
          torch.log(smoothed) - torch.log(smoothed.sum(1, keepdim=True)))
    return self

  def _joint_log_likelihood(self, X):
    X = X.to(torch.int64)
    jll = torch.zeros(X.shape[0], self.classes_.numel(), dtype=torch.float64,
                      device=X.device)
    for j, flp in enumerate(self.feature_log_prob_):
      if bool((X[:, j] >= flp.shape[1]).any()):
        raise IndexError(f"feature {j} has a category unseen in fit")
      jll += flp[:, X[:, j]].T
    return jll + self.class_log_prior_


def fast_naive_bayes(X, y, distribution: str = "bernoulli", alpha: float = 1.0,
                     fit_prior: bool = True, class_prior=None, device=None):
  """A fitted naive Bayes of `distribution` ('bernoulli', 'categorical' or
  'multinomial')."""
  nb_cls = {"bernoulli": BernoulliNB, "categorical": CategoricalNB,
            "multinomial": MultinomialNB}
  if distribution not in nb_cls:
    raise ValueError(f"unknown NB distribution: {distribution}")
  return nb_cls[distribution](alpha=alpha, fit_prior=fit_prior,
                              class_prior=class_prior, device=device).fit(X, y)
