"""Host utilities of the port (a copy of ``md5_checksum``,
``odin_tpu/utils/__init__.py:91``)."""
from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any

import numpy as np

__all__ = ["md5_checksum"]


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
