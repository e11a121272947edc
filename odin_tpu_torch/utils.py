"""Host utilities of the port (a copy of ``as_tuple`` and ``md5_checksum``,
``odin_tpu/utils/__init__.py:39,91``)."""
from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Optional

import numpy as np

__all__ = ["as_tuple", "md5_checksum"]


def as_tuple(x: Any, N: Optional[int] = None, t: Optional[type] = None) -> tuple:
  """Coerce `x` into a tuple, optionally repeated to length `N` and cast to `t`:
  scalars are repeated; sequences of length 1 are broadcast to N; length
  mismatches raise."""
  if isinstance(x, (list, tuple, np.ndarray)) and not isinstance(x, str):
    x = tuple(x)
  else:
    x = (x,)
  if N is not None:
    if len(x) == 1:
      x = x * int(N)
    elif len(x) != N:
      raise ValueError(f"expected {N} values but got {len(x)}: {x}")
  if t is not None:
    x = tuple(t(i) for i in x)
  return x


def md5_checksum(obj: Any) -> str:
  """md5 of a file path, bytes, ndarray, or any picklable object."""
  md5 = hashlib.md5()
  if isinstance(obj, str) and os.path.isfile(obj):
    with open(obj, "rb") as f:
      for chunk in iter(lambda: f.read(1 << 20), b""):
        md5.update(chunk)
  elif isinstance(obj, bytes):
    md5.update(obj)
  elif isinstance(obj, np.ndarray):
    md5.update(np.ascontiguousarray(obj).tobytes())
  else:
    md5.update(pickle.dumps(obj))
  return md5.hexdigest()
