"""Host utilities of the port (a copy of ``as_tuple``, ``md5_checksum`` and
the managed directories under ``$ODIN_TPU_HOME``,
``odin_tpu/utils/__init__.py:39,91,129-146``)."""
from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Optional

import numpy as np

__all__ = ["as_tuple", "md5_checksum", "get_data_path", "get_cache_path",
           "get_exp_path"]


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


def _managed_path(kind: str) -> str:
  base = os.environ.get("ODIN_TPU_HOME",
                        os.path.join(os.path.expanduser("~"), ".odin_tpu"))
  path = os.path.join(base, kind)
  os.makedirs(path, exist_ok=True)
  return path


def get_data_path() -> str:
  """``$ODIN_TPU_HOME/datasets`` (``~/.odin_tpu`` without the variable),
  made if absent: where datasets' files and the full-grid caches lie, the
  same directory the JAX package reads."""
  return _managed_path("datasets")


def get_cache_path() -> str:
  """``$ODIN_TPU_HOME/cache``, made if absent."""
  return _managed_path("cache")


def get_exp_path() -> str:
  """``$ODIN_TPU_HOME/experiments``, made if absent."""
  return _managed_path("experiments")
