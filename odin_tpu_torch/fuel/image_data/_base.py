"""ImageDataset: normalization and semi-supervised batches (PyTorch port of
``odin_tpu/fuel/image_data/_base.py``).

``create_dataset`` yields the JAX package's batches bit for bit: x alone,
(x, one-hot y), or semi-supervised (x, y, mask) batches in which
``round(oversample_ratio * batch_size)`` rows are labelled, with the
labelled rows picked stratified by class.
"""
from __future__ import annotations

from typing import Union

import numpy as np

from odin_tpu_torch.fuel.dataset_base import IterableDataset
from odin_tpu_torch.fuel.pipeline import (DataPipeline, _arrive,
                                          device_transfer)

__all__ = ["ImageDataset"]


def _stratified_label_indices(y: np.ndarray, n_labeled: int,
                              seed: int) -> np.ndarray:
  """Pick `n_labeled` indices stratified by class, topped up at random."""
  rng = np.random.RandomState(seed)
  y_cls = y.argmax(-1) if y.ndim > 1 else y
  classes = np.unique(y_cls)
  per_class = max(1, n_labeled // len(classes))
  chosen = []
  for c in classes:
    idx = np.where(y_cls == c)[0]
    chosen.append(rng.choice(idx, size=min(per_class, len(idx)),
                             replace=False))
  chosen = np.concatenate(chosen)
  if len(chosen) < n_labeled:
    rest = np.setdiff1d(np.arange(len(y_cls)), chosen)
    extra = rng.choice(rest, size=n_labeled - len(chosen), replace=False)
    chosen = np.concatenate([chosen, extra])
  return np.sort(chosen[:n_labeled])


class _SemiPipeline:
  """Semi-supervised (x, y, mask) batches: each holds `n_lab_batch`
  labelled rows drawn from `lab_idx`, then the next `n_unlab_batch` rows
  of the unlabelled order."""

  def __init__(self, x, y, lab_idx, unlab_idx, n_lab_batch, n_unlab_batch,
               shuffle, epochs, seed, to_device):
    self.x, self.y = x, y
    self.lab_idx, self.unlab_idx = lab_idx, unlab_idx
    self.n_lab_batch, self.n_unlab_batch = n_lab_batch, n_unlab_batch
    self.shuffle, self.epochs = shuffle, epochs
    self.rng = np.random.RandomState(seed)
    self.to_device = to_device
    self._transfer = device_transfer(to_device)
    self.steps_per_epoch = max(1, len(unlab_idx) // max(n_unlab_batch, 1))

  def __iter__(self):
    x, y, rng = self.x, self.y, self.rng
    n_unlab = self.n_unlab_batch
    epoch = 0
    while self.epochs < 0 or epoch < self.epochs:
      order = rng.permutation(self.unlab_idx) if self.shuffle \
          else self.unlab_idx
      for i in range(0, len(order) - (n_unlab - 1), n_unlab):
        u = order[i:i + n_unlab]
        l = rng.choice(self.lab_idx, size=self.n_lab_batch,
                       replace=len(self.lab_idx) < self.n_lab_batch)
        xb = np.concatenate([x[l], x[u]], 0)
        yb = np.concatenate([y[l], np.zeros((len(u),) + y.shape[1:],
                                            y.dtype)], 0)
        mb = np.concatenate([np.ones(len(l), "float32"),
                             np.zeros(len(u), "float32")])
        batch = (xb, yb, mb)
        if self._transfer is not None:
          batch = _arrive(self._transfer(batch))
        yield batch
      epoch += 1


class ImageDataset(IterableDataset):
  """Image datasets with the JAX package's ``create_dataset``."""

  @property
  def data_type(self) -> str:
    return "image"

  @property
  def binarized(self) -> bool:
    return False

  def normalize255(self, x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype == np.uint8 or x.max() > 1.5:
      return x.astype("float32") / 255.0
    return x.astype("float32")

  def create_dataset(self,
                     partition: str = "train",
                     *,
                     batch_size: int = 32,
                     drop_remainder: bool = False,
                     shuffle: Union[bool, int] = 1000,
                     prefetch: int = 2,
                     normalize: str = "probs",
                     label_percent: Union[bool, float, int] = 0.0,
                     oversample_ratio: float = 0.5,
                     fixed_oversample: bool = True,
                     epochs: int = -1,
                     seed: int = 1,
                     binarize: bool = False,
                     to_device=None):
    """Batches of a partition.

    normalize: 'probs' (in [0, 1]), 'tanh' (in [-1, 1]) or 'raster' (in
      [0, 255]).
    label_percent:
      0 / False  -> batches of x only;
      True / 1.0 -> fully labelled (x, one-hot y) batches;
      a float in (0, 1) or an int count -> semi-supervised (x, y, mask)
        batches with `oversample_ratio` labelled rows per batch.
    to_device: see ``DataPipeline``.
    """
    x, y = self._load(partition)
    x = self.normalize255(x)
    if binarize:
      x = (x > 0.5).astype("float32")
    if normalize in ("tanh",):
      x = 2.0 * x - 1.0
    elif normalize in ("raster",):
      x = x * 255.0
    elif normalize not in ("probs", None, "none"):
      raise ValueError(f"unknown normalize '{normalize}'")
    kw = dict(batch_size=batch_size, shuffle=shuffle, epochs=epochs,
              drop_remainder=drop_remainder, seed=seed, prefetch=prefetch,
              to_device=to_device)
    if label_percent in (0, 0.0, False, None) or y is None:
      return DataPipeline(x, **kw)
    y = np.asarray(y)
    if y.ndim == 1 and self.n_labels > 0:
      y = np.eye(self.n_labels, dtype="float32")[y.astype("int64")]
    if label_percent in (True, 1, 1.0):
      return DataPipeline((x, y), **kw)
    n = len(x)
    n_labeled = int(label_percent) if label_percent >= 1 else \
        int(np.round(float(label_percent) * n))
    lab_idx = _stratified_label_indices(y, n_labeled, seed)
    lab_mask = np.zeros(n, bool)
    lab_mask[lab_idx] = True
    n_lab_batch = max(1, int(np.round(oversample_ratio * batch_size)))
    return _SemiPipeline(x, y, lab_idx, np.where(~lab_mask)[0], n_lab_batch,
                         batch_size - n_lab_batch, shuffle, epochs, seed,
                         to_device)

  def sample_images(self, n: int = 16, partition: str = "train",
                    seed: int = 1) -> np.ndarray:
    """`n` images drawn without replacement, normalized to [0, 1]."""
    x, _ = self._load(partition)
    rng = np.random.RandomState(seed)
    idx = rng.choice(len(x), size=min(n, len(x)), replace=False)
    return self.normalize255(x[idx])
