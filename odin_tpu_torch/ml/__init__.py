"""Classical ML of the port (PyTorch port of ``odin_tpu/ml``), on the card
unless the caller asks for the CPU: speaker recognition (GMM-UBM,
T-matrix, i-vectors, WCCN/LDA/cosine and SVM scoring, PLDA), the JAX
package's k-means (``KMeansJax``), and scikit-learn's estimators carried
in torch: k-means, k-NN, DBSCAN and naive Bayes (``ml/cluster.py``),
t-SNE (``ml/tsne.py``), PCA and incremental PCA (``ml/decompositions.py``,
with the JAX package's ``fast_pca``, ``PPCA``, ``SupervisedPPCA``,
``MiniBatchPCA`` and ``RandomizedPCA``), linear discriminant analysis
(``ml/discriminant.py``), Gaussian mixtures (``ml/mixture.py``, under the
GMM embeddings of ``ml/gmm_embedding.py``), ``SVC`` (``ml/svm.py``),
random forests (``ml/forest.py``) and batch LDA topic models
(``ml/topics.py``); the logistic regression, linear SVM and boosted trees
of ``bay/vi/estimators.py``; ``evaluate`` and ``Evaluable``
(``ml/base.py``); the ``Transformer`` sentence embedder.
"""
from enum import IntFlag as _IntFlag, auto as _auto

from odin_tpu_torch.ml.base import Evaluable, evaluate
from odin_tpu_torch.ml.cluster import (KMeansJax, dbscan_predict, fast_dbscan,
                                       fast_kmeans, fast_knn,
                                       fast_naive_bayes)
from odin_tpu_torch.ml.decompositions import (MiniBatchPCA, PPCA,
                                              RandomizedPCA, SupervisedPPCA,
                                              fast_pca)
from odin_tpu_torch.ml.discriminant import LinearDiscriminantAnalysis
from odin_tpu_torch.ml.forest import fast_rf_classifier
from odin_tpu_torch.ml.gmm_embedding import (GMMclassifier, GMMThreshold,
                                             ProbabilisticEmbedding)
from odin_tpu_torch.ml.gmm_tmat import GMM, Tmatrix
from odin_tpu_torch.ml.ivector import Ivector
from odin_tpu_torch.ml.neural_nlp import Transformer
from odin_tpu_torch.ml.plda import PLDA
from odin_tpu_torch.ml.scoring import (Scorer, VectorNormalizer,
                                       compute_class_avg, compute_wccn,
                                       compute_within_cov)
from odin_tpu_torch.ml.svm import fast_svc
from odin_tpu_torch.ml.topics import fast_lda_topics, get_topics_string
from odin_tpu_torch.ml.tsne import TSNE

__all__ = [
    "GMM", "Tmatrix", "Ivector", "PLDA", "PPCA", "SupervisedPPCA",
    "MiniBatchPCA", "fast_pca", "VectorNormalizer", "Scorer", "KMeansJax",
    "fast_kmeans", "fast_knn", "fast_dbscan", "compute_wccn",
    "compute_class_avg", "compute_within_cov", "fast_tsne", "fast_umap",
    "fast_svc", "fast_logistic_regression", "fast_gbtree_classifier",
    "fast_rf_classifier", "linear_classifier", "fast_lda_topics",
    "RandomizedPCA", "Transformer", "Evaluable", "evaluate",
]


def fast_tsne(*x, n_components: int = 2, perplexity: float = 30.0,
              random_state: int = 1, **kwargs):
  """The t-SNE embedding of each array (perplexity at most n − 1), each
  fitted apart."""
  out = []
  for a in x:
    model = TSNE(n_components=n_components,
                 perplexity=min(perplexity, len(x[0]) - 1),
                 random_state=random_state, **kwargs)
    out.append(model.fit_transform(a))
  return out[0] if len(x) == 1 else tuple(out)


def fast_umap(*x, n_components: int = 2, random_state: int = 1, **kwargs):
  """UMAP where ``umap`` is installed (on the host), else ``fast_tsne``,
  as the JAX package falls back."""
  try:
    import umap
    import numpy as np
    host = [a.detach().cpu().numpy() if hasattr(a, "detach") else
            np.asarray(a) for a in x]
    model = umap.UMAP(n_components=n_components, random_state=random_state,
                      **kwargs)
    out = model.fit_transform(host[0])
    return out if len(x) == 1 else (out,) + tuple(
        model.transform(a) for a in host[1:])
  except ImportError:
    return fast_tsne(*x, n_components=n_components,
                     random_state=random_state)


def fast_logistic_regression(X, y, *, max_iter: int = 2000, **kwargs):
  """The port's ``LogisticRegression`` (``bay/vi/estimators.py``) fitted
  on (X, y)."""
  from odin_tpu_torch.bay.vi.estimators import LogisticRegression
  return LogisticRegression(max_iter=max_iter, **kwargs).fit(X, _ravel(y))


def fast_gbtree_classifier(X, y, *, n_estimators: int = 100,
                           random_state: int = 1, **kwargs):
  """The port's ``GradientBoostingClassifier`` fitted on (X, y)."""
  from odin_tpu_torch.bay.vi.estimators import GradientBoostingClassifier
  kwargs.pop("n_jobs", None)
  return GradientBoostingClassifier(n_estimators=n_estimators,
                                    random_state=random_state,
                                    **kwargs).fit(X, _ravel(y))


def _ravel(y):
  return y.reshape(-1) if hasattr(y, "reshape") and not isinstance(
      y, (list, tuple)) else y


def linear_classifier(X, y, algo: str = "lda", **kwargs):
  """A fitted classifier by name: 'lda', 'svm' (or 'svc'), 'logistic'
  (or 'logit'), 'gbt' (or 'gbtree'), 'rf' (or 'randomforest')."""
  algo = str(algo).lower()
  if algo == "lda":
    return LinearDiscriminantAnalysis(**kwargs).fit(X, _ravel(y))
  if algo in ("svm", "svc"):
    return fast_svc(X, y, **kwargs)
  if algo in ("logistic", "logit"):
    return fast_logistic_regression(X, y, **kwargs)
  if algo in ("gbt", "gbtree"):
    return fast_gbtree_classifier(X, y, **kwargs)
  if algo in ("rf", "randomforest"):
    return fast_rf_classifier(X, y, **kwargs)
  raise ValueError(f"unknown classifier algo '{algo}'")


def clustering(X, algo, n_clusters: int = 8, random_state: int = 1,
               **kwargs):
  """A fitted clustering by name: 'kmeans', 'knn' or 'dbscan'."""
  algo = str(algo).strip().lower()
  if "kmean" in algo:
    return fast_kmeans(X, n_clusters=n_clusters, random_state=random_state,
                       **kwargs)
  if "knn" in algo:
    return fast_knn(X, n_neighbors=kwargs.pop("n_neighbors", n_clusters),
                    **kwargs)
  if "dbscan" in algo:
    return fast_dbscan(X, **kwargs)
  raise ValueError(f"no clustering algorithm named '{algo}'")


def dimension_reduce(*X, algo: str = "pca", n_components: int = 2,
                     random_state: int = 1, **kwargs):
  """Dimension reduction by name ('pca', 'umap', 'tsne', 'kmeans' or
  'knn') of one or more arrays, fitted on the first."""
  algo = str(algo).strip().lower()
  if "pca" in algo:
    return fast_pca(*X, n_components=n_components, **kwargs)
  if "umap" in algo:
    return fast_umap(*X, n_components=n_components,
                     random_state=random_state, **kwargs)
  if "tsne" in algo:
    return fast_tsne(*X, n_components=n_components,
                     random_state=random_state, **kwargs)
  if "kmean" in algo:
    model = fast_kmeans(X[0], n_clusters=n_components,
                        random_state=random_state, **kwargs)
    out = [model.transform(x) for x in X]
    return out[0] if len(X) == 1 else tuple(out)
  if "knn" in algo:
    model = fast_knn(X[0], n_neighbors=n_components, **kwargs)
    out = [model.kneighbors(x)[0] for x in X]
    return out[0] if len(X) == 1 else tuple(out)
  raise ValueError(f"no dimension-reduction algorithm named '{algo}'")


class DimReduce(_IntFlag):
  """Composable dimension-reduction selector: ``(DimReduce.PCA |
  DimReduce.TSNE)(X)`` runs each selected method and returns the list of
  results (the one result for a single method)."""

  PCA = _auto()
  UMAP = _auto()
  TSNE = _auto()
  KNN = _auto()
  KMEANS = _auto()

  def __iter__(self):
    for m in type(self):
      if m in self:
        yield m

  def __len__(self):
    return len(list(iter(self)))

  @property
  def is_single(self) -> bool:
    return len(self) == 1

  def __call__(self, *X, n_components: int = 2, random_state: int = 1,
               **kwargs):
    outs = [dimension_reduce(*X, algo=m.name.lower(),
                             n_components=n_components,
                             random_state=random_state, **kwargs)
            for m in iter(self)]
    return outs[0] if len(outs) == 1 else outs


__all__ += ["clustering", "dimension_reduce", "DimReduce", "evaluate",
            "get_topics_string"]
