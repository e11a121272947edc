"""Classical ML of the port (PyTorch port of ``odin_tpu/ml``), on the card
unless the caller asks for the CPU: speaker recognition (GMM-UBM,
T-matrix, i-vectors, WCCN/cosine scoring, PLDA), the JAX package's k-means
(``KMeansJax``), scikit-learn's k-means, k-NN, DBSCAN and naive Bayes
carried in torch (``fast_kmeans``, ``fast_knn``, ``fast_dbscan``,
``dbscan_predict``, ``fast_naive_bayes``, ``clustering``), and t-SNE
(``fast_tsne``).

The other names of ``odin_tpu.ml`` (the PCA family and
``dimension_reduce``, the GMM embeddings, the other scikit-learn wrappers,
``evaluate``) are not ported yet (ROADMAP.md queue 1, item 6).
"""
from odin_tpu_torch.ml.cluster import (KMeansJax, dbscan_predict, fast_dbscan,
                                       fast_kmeans, fast_knn,
                                       fast_naive_bayes)
from odin_tpu_torch.ml.gmm_tmat import GMM, Tmatrix
from odin_tpu_torch.ml.ivector import Ivector
from odin_tpu_torch.ml.plda import PLDA
from odin_tpu_torch.ml.scoring import (Scorer, VectorNormalizer,
                                       compute_class_avg, compute_wccn,
                                       compute_within_cov)
from odin_tpu_torch.ml.tsne import TSNE

__all__ = ["GMM", "Tmatrix", "Ivector", "PLDA", "Scorer",
           "VectorNormalizer", "compute_wccn", "compute_class_avg",
           "compute_within_cov", "KMeansJax", "fast_kmeans", "fast_knn",
           "fast_dbscan", "dbscan_predict", "fast_naive_bayes", "fast_tsne",
           "clustering"]


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
