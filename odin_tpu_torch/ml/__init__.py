"""Classical ML of the port: speaker recognition on the card (PyTorch port
of ``odin_tpu/ml``'s GMM-UBM, T-matrix, i-vectors, WCCN/cosine scoring and
PLDA).

The other names of ``odin_tpu.ml`` (PCA variants, k-means and the other
clusterings, the GMM embeddings, the scikit-learn wrappers, ``evaluate``)
are not ported yet (ROADMAP.md queue 1, item 6).
"""
from odin_tpu_torch.ml.gmm_tmat import GMM, Tmatrix
from odin_tpu_torch.ml.ivector import Ivector
from odin_tpu_torch.ml.plda import PLDA
from odin_tpu_torch.ml.scoring import (Scorer, VectorNormalizer,
                                       compute_class_avg, compute_wccn,
                                       compute_within_cov)

__all__ = ["GMM", "Tmatrix", "Ivector", "PLDA", "Scorer",
           "VectorNormalizer", "compute_wccn", "compute_class_avg",
           "compute_within_cov"]
