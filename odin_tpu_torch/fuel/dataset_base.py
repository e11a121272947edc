"""Partition selection (a copy of ``get_partition``,
``odin_tpu/fuel/dataset_base.py:18``)."""
from __future__ import annotations

__all__ = ["get_partition"]


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
