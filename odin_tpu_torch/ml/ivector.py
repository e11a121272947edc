"""Ivector of the port: GMM -> statistics -> T-matrix -> i-vectors (PyTorch
port of ``odin_tpu/ml/ivector.py``).

Fits the UBM, extracts the (Z, F) statistics of every utterance, trains the
T-matrix and extracts i-vectors, all on `device`, with the JAX package's
on-disk cache of every stage under `path`: ``gmm.pkl``, ``stats.npz``,
``tmatrix.pkl`` and ``ivecs.npy``, holding numpy arrays, so that a cache
written by either package loads in the other.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence, Union

import numpy as np
import torch

from odin_tpu_torch.ml.gmm_tmat import GMM, Tmatrix, _concat, _numpy, _on

__all__ = ["Ivector"]


class Ivector:
  """``Ivector(nmix, tv_dim).fit_transform(utterances)``: utterances are a
  list of (T_i, D) feature matrices, numpy arrays or tensors; the i-vectors
  are a float32 (n, tv_dim) tensor on the device."""

  def __init__(self,
               path: Optional[str] = None,
               nmix: int = 64,
               tv_dim: int = 100,
               niter_gmm: Optional[Sequence[int]] = None,
               niter_tmat: int = 10,
               batch_size: int = 8192,
               seed: int = 1,
               device: Union[str, torch.device] = "cuda"):
    self.path = path
    if path is not None:
      os.makedirs(path, exist_ok=True)
    self.gmm = GMM(nmix=nmix, niter=niter_gmm, batch_size=batch_size,
                   seed=seed, device=device)
    self.device = self.gmm.device
    self.tmat = Tmatrix(tv_dim=tv_dim, gmm=self.gmm, niter=niter_tmat,
                        seed=seed, device=self.device)

  def _cache(self, name):
    return os.path.join(self.path, name) if self.path else None

  def fit(self, utterances: Sequence, verbose: bool = False) -> "Ivector":
    """The UBM, the statistics and the T-matrix, each loaded from the cache
    where it is there, else computed (and cached)."""
    gmm_path = self._cache("gmm.pkl")
    if gmm_path and os.path.exists(gmm_path):
      self.gmm = GMM.load(gmm_path, self.device)
      self.tmat.gmm = self.gmm
    else:
      self.gmm.fit(_concat(utterances, self.device), verbose=verbose)
      if gmm_path:
        self.gmm.save(gmm_path)
    zf_path = self._cache("stats.npz")
    if zf_path and os.path.exists(zf_path):
      with np.load(zf_path) as d:
        Z = _on(d["Z"], self.device, torch.float32)
        F = _on(d["F"], self.device, torch.float32)
    else:
      Z, F = self.gmm.transform_batch(utterances)
      if zf_path:
        np.savez(zf_path, Z=_numpy(Z), F=_numpy(F))
    tm_path = self._cache("tmatrix.pkl")
    if tm_path and os.path.exists(tm_path):
      with open(tm_path, "rb") as f:
        self.tmat.Tm = _on(pickle.load(f)["Tm"], self.device, torch.float64)
    else:
      self.tmat.fit((Z, F), verbose=verbose)
      if tm_path:
        self.tmat.save(tm_path)
    return self

  def transform(self, utterances: Sequence) -> torch.Tensor:
    """Utterance features -> i-vectors (n, tv_dim)."""
    return self.tmat.transform(self.gmm.transform_batch(utterances))

  def fit_transform(self, utterances, verbose: bool = False) -> torch.Tensor:
    self.fit(utterances, verbose=verbose)
    ivec_path = self._cache("ivecs.npy")
    if ivec_path and os.path.exists(ivec_path):
      return _on(np.load(ivec_path), self.device, torch.float32)
    ivecs = self.transform(utterances)
    if ivec_path:
      np.save(ivec_path, _numpy(ivecs))
    return ivecs
