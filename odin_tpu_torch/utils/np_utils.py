"""NumPy helpers.

Reference: ``odin/utils/np_utils.py`` — fast array<->bytes serialization,
`one_hot`, `unique_labels` (object -> stable label index), and
`label_splitter` (pos/delimiter field extraction for filename-encoded
labels).  The bytes format here is self-describing (dtype name + shape in a
marshal trailer) rather than the reference's fixed lookup tables, so any
dtype/ndim round-trips.

The port's copy of the JAX package's ``odin_tpu/utils/np_utils.py``, which
imports no JAX.
"""
from __future__ import annotations

import marshal
import struct
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["array2bytes", "bytes2array", "one_hot", "unique_labels",
           "label_splitter"]


def array2bytes(a: np.ndarray) -> bytes:
  """Serialize an array and all its metadata to bytes (reference
  ``np_utils.py:47``): raw buffer + marshaled (dtype-name, shape) trailer +
  trailer length."""
  a = np.ascontiguousarray(a)
  meta = marshal.dumps((a.dtype.str, a.shape), 2)
  return a.tobytes() + meta + struct.pack("<I", len(meta))


def bytes2array(b: bytes) -> np.ndarray:
  """Deserialize :func:`array2bytes` output (reference ``np_utils.py:56``)."""
  n_meta = struct.unpack("<I", b[-4:])[0]
  dtype_str, shape = marshal.loads(b[-4 - n_meta:-4])
  return np.frombuffer(b[:-4 - n_meta], dtype=np.dtype(dtype_str)).reshape(
      shape)


def one_hot(y: np.ndarray, nb_classes: Optional[int] = None,
            dtype: str = "float32") -> np.ndarray:
  """Integer class vector -> one-hot matrix (reference ``np_utils.py:99``);
  negative class indices get an all-zero row."""
  y = np.asarray(y)
  if "int" not in str(y.dtype):
    y = y.astype("int32")
  if nb_classes is None:
    nb_classes = int(np.max(y)) + 1
  out = np.zeros(y.shape + (int(nb_classes),), dtype=dtype)
  valid = y >= 0
  idx = np.nonzero(valid)
  out[idx + (y[valid],)] = 1
  return out


class _LabelsIndexing:
  """Callable object -> stable label index (picklable, reference
  ``np_utils.py:68``)."""

  def __init__(self, key_func: Callable, fast_index: dict,
               sorted_labels: Tuple):
    self._key_func = key_func
    self._fast_index = fast_index
    self._sorted_labels = sorted_labels

  @property
  def labels(self) -> Tuple:
    return tuple(self._sorted_labels)

  def __call__(self, x) -> int:
    key = self._key_func(x)
    if key in self._fast_index:
      return self._fast_index[key]
    raise ValueError(f"Cannot find key {key!r} in {self._sorted_labels}")


def unique_labels(y: Sequence, key_func: Optional[Callable] = None,
                  return_labels: bool = False):
  """Build a function mapping each object to a stable label index
  (reference ``np_utils.py:116``): labels are the sorted unique
  ``key_func`` images of `y`.  With ``return_labels`` also returns the
  ordered label tuple."""
  if not isinstance(y, (list, tuple, np.ndarray)):
    raise ValueError("`y` must be a list, tuple or ndarray")
  if key_func is None or not callable(key_func):
    key_func = str
  sorted_labels = tuple(sorted({key_func(i) for i in y}))
  fast_index = {label: i for i, label in enumerate(sorted_labels)}
  indexer = _LabelsIndexing(key_func, fast_index, sorted_labels)
  if return_labels:
    return indexer, sorted_labels
  return indexer


class _LabelSplitHelper:
  """Picklable pos/delimiter splitter (reference ``np_utils.py:155``)."""

  def __init__(self, pos: int, delimiter: str):
    self.pos = int(pos)
    self.delimiter = str(delimiter)

  def __call__(self, x) -> str:
    if isinstance(x, str):
      return x.split(self.delimiter)[self.pos]
    if isinstance(x, (tuple, list, np.ndarray)):
      for item in x:
        if isinstance(item, str):
          return item.split(self.delimiter)[self.pos]
    raise RuntimeError(f"Unsupported type {type(x)} for label splitter")


def label_splitter(pos: int, delimiter: str = "/") -> Callable:
  """Field extractor for delimiter-encoded labels (e.g. speaker id from
  ``'spk/utt'`` paths; reference ``np_utils.py:173``)."""
  return _LabelSplitHelper(pos, delimiter)
