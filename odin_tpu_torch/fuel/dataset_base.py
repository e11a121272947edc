"""Dataset base API (PyTorch port of ``odin_tpu/fuel/dataset_base.py``):
partition selection (``get_partition``) and ``IterableDataset``, whose
``create_dataset(partition, ...)`` returns a ``DataPipeline``."""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np

from odin_tpu_torch.fuel.pipeline import DataPipeline

__all__ = ["get_partition", "IterableDataset"]


def get_partition(partition: str, train=None, valid=None, test=None,
                  unlabeled=None, unlabelled=None, all=None):
  """Select a data partition by name."""
  partition = str(partition).lower().strip()
  mapping = dict(train=train, valid=valid, val=valid, test=test,
                 unlabeled=unlabeled, unlabelled=unlabelled or unlabeled,
                 all=all)
  if partition not in mapping:
    raise ValueError(f"unknown partition '{partition}'; "
                     f"available: {sorted(k for k, v in mapping.items() if v is not None)}")
  out = mapping[partition]
  if out is None:
    raise ValueError(f"partition '{partition}' is not available for this dataset")
  return out


class IterableDataset:
  """Base dataset: a subclass provides ``_load(partition)`` returning
  (x, y or None) as numpy arrays."""

  def __init__(self, seed: int = 1):
    self.seed = int(seed)

  @property
  def name(self) -> str:
    return type(self).__name__.lower()

  @property
  def data_type(self) -> str:
    return "unknown"

  # -- the subclass's part ------------------------------------------------
  def _load(self, partition: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    raise NotImplementedError

  @property
  def shape(self) -> Tuple[int, ...]:
    """Shape of one example."""
    raise NotImplementedError

  @property
  def full_shape(self) -> Tuple[Optional[int], ...]:
    return (None,) + tuple(self.shape)

  @property
  def labels(self) -> List[str]:
    return []

  @property
  def n_labels(self) -> int:
    return len(self.labels)

  @property
  def has_labels(self) -> bool:
    return self.n_labels > 0

  # -- API ------------------------------------------------------------------
  def create_dataset(self,
                     partition: str = "train",
                     batch_size: int = 32,
                     drop_remainder: bool = False,
                     shuffle: Union[bool, int] = 1000,
                     prefetch: int = 2,
                     inc_labels: Union[bool, float] = False,
                     epochs: int = -1,
                     seed: int = 1,
                     to_device=None) -> DataPipeline:
    """An iterable of batches: x alone, or (x, y) with `inc_labels`."""
    x, y = self._load(partition)
    arrays = x if (not inc_labels or y is None) else (x, y)
    return DataPipeline(arrays, batch_size=batch_size, shuffle=shuffle,
                        epochs=epochs, drop_remainder=drop_remainder,
                        seed=seed, prefetch=prefetch, to_device=to_device)

  def numpy(self, partition: str = "train", n: Optional[int] = None,
            inc_labels: bool = True):
    """A partition as arrays: x, or (x, y) with `inc_labels`."""
    x, y = self._load(partition)
    if n is not None:
      x = x[:n]
      y = y[:n] if y is not None else None
    return (x, y) if inc_labels and y is not None else x
