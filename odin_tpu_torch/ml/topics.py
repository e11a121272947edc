"""scikit-learn 1.9's ``LatentDirichletAllocation`` (``learning_method=
'batch'``, the JAX package's ``fast_lda_topics``) carried in torch, on the
device of its input (``sklearn/decomposition/_lda.py``,
``_online_lda_fast.pyx``).

As scikit-learn: a float32 count matrix is fitted in float32 and any other
in float64; ``components_`` starts from ``RandomState(random_state)``'s
``gamma(100, 0.01)`` draw and each training E-step's document topics from
the next ``gamma(100, 0.01)`` draw of the same stream, so every draw is
replayed in order on the host; each document's fixed point (``norm_phi``,
then the Dirichlet expectation after adding the prior) runs until its mean
change falls below ``mean_change_tol`` or ``max_doc_update_iter``, and a
document that has stopped keeps its topics while the others go on (all
documents are one batch of matmuls over the dense counts, in which a word
of count 0 adds nothing); the M-step is ``topic_word_prior`` plus the
sufficient statistics times ``exp(E[log β])``; on the card the fixed
point runs as CUDA graphs of ``STOP_CHECK`` iterations.  The digamma is
scikit-learn's own (its series after shifting to x >= 6), not the exact
one.  ``transform``, ``score``, ``perplexity`` and
``exp_dirichlet_component_`` are ported; ``evaluate_every`` > 0 also
records each evaluated perplexity in ``perplexities_``.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from odin_tpu_torch.device import as_tensor, device_of, iterate
from odin_tpu_torch.ml.gmm_tmat import ieee_fp32_matmuls

__all__ = ["LatentDirichletAllocation", "fast_lda_topics",
           "get_topics_string", "psi"]

EULER = 0.577215664901532860606512090082402431
# fixed-point iterations between two reads of the stops on the host (and
# in one CUDA graph on the card)
STOP_CHECK = 8


def psi(x: torch.Tensor) -> torch.Tensor:
  """scikit-learn's digamma (``_online_lda_fast.psi``) elementwise."""
  small = x <= 1e-6
  x0 = x
  result = torch.zeros_like(x)
  for _ in range(6):  # shift x up to at least 6
    low = x < 6
    result = torch.where(low, result - 1.0 / x, result)
    x = torch.where(low, x + 1, x)
  r = 1.0 / x
  result = result + torch.log(x) - 0.5 * r
  r = r * r
  result = result - r * ((1.0 / 12.0) - r * ((1.0 / 120.0) -
                                              r * (1.0 / 252.0)))
  return torch.where(small, -EULER - 1.0 / torch.where(small, x0, 1.0),
                     result)


def _dirichlet_expectation_2d(arr: torch.Tensor) -> torch.Tensor:
  return psi(arr) - psi(arr.sum(1))[:, None]


def _host(x) -> np.ndarray:
  return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
      np.asarray(x)


class LatentDirichletAllocation:
  """scikit-learn's batch ``LatentDirichletAllocation`` (see the module
  docstring)."""

  def __init__(self, n_components: int = 10, *, doc_topic_prior=None,
               topic_word_prior=None, learning_method: str = "batch",
               max_iter: int = 10, evaluate_every: int = -1,
               perp_tol: float = 1e-1, mean_change_tol: float = 1e-3,
               max_doc_update_iter: int = 100, random_state=None,
               device=None, **kwargs):
    if learning_method != "batch" or kwargs:
      raise NotImplementedError(
          f"LatentDirichletAllocation options learning_method="
          f"{learning_method!r} {sorted(kwargs)} are not ported")
    self.n_components = int(n_components)
    self.doc_topic_prior = doc_topic_prior
    self.topic_word_prior = topic_word_prior
    self.learning_method = learning_method
    self.max_iter = int(max_iter)
    self.evaluate_every = int(evaluate_every)
    self.perp_tol = float(perp_tol)
    self.mean_change_tol = float(mean_change_tol)
    self.max_doc_update_iter = int(max_doc_update_iter)
    self.random_state = random_state
    self.device = device

  def _check(self, X, device=None) -> torch.Tensor:
    X = as_tensor(X, device)
    if X.dtype not in (torch.float32, torch.float64):
      X = X.to(torch.float64)
    if bool((X < 0).any()):
      raise ValueError("Negative values in data passed to "
                       "LatentDirichletAllocation")
    return X

  def _doc_topics(self, X, init, cal_sstats):
    """The per-document fixed point from `init` (n, K); -> (doc topics,
    sufficient statistics or None)."""
    dt = X.dtype
    eps = torch.finfo(dt).eps
    exp_tw = self.exp_dirichlet_component_
    doc = init.clone()
    exp_doc = torch.exp(_dirichlet_expectation_2d(doc))
    active = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)

    def step():
      """One fixed-point iteration of every document that goes on, in
      place; a stopped document is left as it is."""
      norm_phi = exp_doc @ exp_tw + eps
      new = exp_doc * ((X / norm_phi) @ exp_tw.T) + self.doc_topic_prior_
      new_exp = torch.exp(psi(new) - psi(new.sum(1, keepdim=True)))
      change = (doc - new).abs().to(torch.float64).mean(1)
      a = active[:, None]
      doc.copy_(torch.where(a, new, doc))
      exp_doc.copy_(torch.where(a, new_exp, exp_doc))
      active.logical_and_(~(change < self.mean_change_tol))

    with ieee_fp32_matmuls():
      iterate(step, lambda: not bool(active.any()), X.device,
              self.max_doc_update_iter, STOP_CHECK, STOP_CHECK)
      suff = None
      if cal_sstats:
        norm_phi = exp_doc @ exp_tw + eps
        suff = (exp_doc.T @ (X / norm_phi)) * exp_tw
    return doc, suff

  def _e_step(self, X, cal_sstats, random_init):
    n = X.shape[0]
    if random_init:
      init = torch.from_numpy(self.random_state_.gamma(
          100.0, 0.01, (n, self.n_components))).to(device=X.device,
                                                    dtype=X.dtype)
    else:
      init = torch.ones(n, self.n_components, dtype=X.dtype,
                        device=X.device)
    return self._doc_topics(X, init, cal_sstats)

  def fit(self, X, y=None) -> "LatentDirichletAllocation":
    X = self._check(X, device_of(X, device=self.device))
    n, V = X.shape
    self.random_state_ = (self.random_state if isinstance(
        self.random_state, np.random.RandomState)
        else np.random.RandomState(self.random_state))
    self.n_batch_iter_ = 1
    self.n_iter_ = 0
    K = self.n_components
    self.doc_topic_prior_ = (1.0 / K if self.doc_topic_prior is None
                             else self.doc_topic_prior)
    self.topic_word_prior_ = (1.0 / K if self.topic_word_prior is None
                              else self.topic_word_prior)
    self.components_ = torch.from_numpy(self.random_state_.gamma(
        100.0, 0.01, (K, V))).to(device=X.device, dtype=X.dtype)
    self.exp_dirichlet_component_ = torch.exp(
        _dirichlet_expectation_2d(self.components_))
    self.perplexities_: List[float] = []
    last_bound = None
    for i in range(self.max_iter):
      _, suff = self._e_step(X, cal_sstats=True, random_init=True)
      self.components_ = self.topic_word_prior_ + suff
      self.exp_dirichlet_component_ = torch.exp(
          _dirichlet_expectation_2d(self.components_))
      self.n_batch_iter_ += 1
      if self.evaluate_every > 0 and (i + 1) % self.evaluate_every == 0:
        doc, _ = self._e_step(X, cal_sstats=False, random_init=False)
        bound = self._perplexity_precomp_distr(X, doc)
        self.perplexities_.append(bound)
        if last_bound and abs(last_bound - bound) < self.perp_tol:
          break
        last_bound = bound
      self.n_iter_ += 1
    doc, _ = self._e_step(X, cal_sstats=False, random_init=False)
    self.bound_ = self._perplexity_precomp_distr(X, doc)
    return self

  def _unnormalized_transform(self, X) -> torch.Tensor:
    return self._e_step(self._check(X, self.components_.device),
                        cal_sstats=False, random_init=False)[0]

  def transform(self, X, *, normalize: bool = True) -> torch.Tensor:
    doc = self._unnormalized_transform(X)
    return doc / doc.sum(1, keepdim=True) if normalize else doc

  def fit_transform(self, X, y=None) -> torch.Tensor:
    return self.fit(X).transform(X)

  def _approx_bound(self, X, doc_topic_distr) -> float:
    """The variational bound: E[log p(docs | θ, β)] + E[log p(θ | α) − log
    q(θ | γ)] + E[log p(β | η) − log q(β | λ)], float."""
    def loglik(prior, distr, dirichlet, size):
      score = torch.sum((prior - distr) * dirichlet)
      score = score + torch.sum(torch.lgamma(distr) - math.lgamma(prior))
      score = score + torch.sum(math.lgamma(prior * size) -
                                torch.lgamma(distr.sum(1)))
      return score

    dd = _dirichlet_expectation_2d(doc_topic_distr)
    dc = _dirichlet_expectation_2d(self.components_)
    # per document and word, logsumexp over topics; counts of 0 add nothing
    score = torch.zeros((), dtype=torch.float64, device=X.device)
    for rows in range(0, X.shape[0], 1024):
      t = dd[rows:rows + 1024, :, None] + dc[None]
      norm_phi = torch.logsumexp(t, dim=1)
      score = score + torch.sum(torch.where(
          X[rows:rows + 1024] > 0, X[rows:rows + 1024] * norm_phi,
          torch.zeros_like(norm_phi)).to(torch.float64))
    score = score + loglik(self.doc_topic_prior_, doc_topic_distr, dd,
                           self.n_components)
    score = score + loglik(self.topic_word_prior_, self.components_, dc,
                           self.components_.shape[1])
    return float(score)

  def _perplexity_precomp_distr(self, X, doc_topic_distr) -> float:
    bound = self._approx_bound(X, doc_topic_distr)
    return float(np.exp(-1.0 * bound / float(X.sum())))

  def score(self, X, y=None) -> float:
    X = self._check(X, self.components_.device)
    return self._approx_bound(X, self._unnormalized_transform(X))

  def perplexity(self, X) -> float:
    X = self._check(X, self.components_.device)
    return self._perplexity_precomp_distr(X, self._unnormalized_transform(X))


def fast_lda_topics(X, *, n_topics: int = 10, max_iter: int = 20,
                    random_state: int = 1, **kwargs
                    ) -> LatentDirichletAllocation:
  """``LatentDirichletAllocation(n_topics, max_iter, random_state)``
  fitted on the count matrix X."""
  return LatentDirichletAllocation(n_components=n_topics, max_iter=max_iter,
                                   random_state=random_state,
                                   **kwargs).fit(X)


def get_topics_string(lda, vocabulary, n_topics: int = 10,
                      n_words: int = 10, show_word_prob: bool = False):
  """One line a topic, the heaviest topics first: its index, its share of
  the topic weights and its `n_words` most probable words."""
  topics = _host(lda.components_).astype(np.float64) \
      if isinstance(lda.components_, torch.Tensor) else \
      np.asarray(lda.components_)
  alpha = topics.sum(1)
  alpha = alpha / alpha.sum()
  topics = topics / topics.sum(1, keepdims=True)
  text = []
  for idx, t in enumerate(np.argsort(-alpha, kind="mergesort")[:n_topics]):
    words = topics[t]
    desc = " ".join(
        f"{vocabulary[i]}_{words[i]:.2f}" if show_word_prob
        else f"{vocabulary[i]}" for i in np.argsort(-words)[:n_words])
    text.append(f"[#{idx}]index:{t:3d} alpha={alpha[t]:.2f} {desc}")
  return np.array(text)
