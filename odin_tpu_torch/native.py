"""ctypes bindings for the native corpus IO engine: a copy of
``odin_tpu/native.py`` over the port's own copy of its source,
``odin_tpu_torch/csrc/odin_io.cpp``.

The library is built with ``g++`` at first use into ``build/odin_tpu_torch/``
(``_build.build_host``; the JAX package's ``native/libodin_io.so`` is never
loaded).  Every entry point keeps the JAX package's NumPy fallback for a
machine with no compiler; `library_file` says which library was loaded.
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["load_native", "native_available", "library_file", "decode_wav",
           "pack_batch", "frame_signal_native", "gather"]

_LIB = None
_TRIED = False
_PATH: Optional[str] = None


def load_native() -> Optional[ctypes.CDLL]:
  """Build (if needed) and load libodin_io; None when unavailable."""
  global _LIB, _TRIED, _PATH
  if _LIB is not None or _TRIED:
    return _LIB
  _TRIED = True
  try:
    from odin_tpu_torch import _build
    path = str(_build.build_host("odin_io"))
    lib = ctypes.CDLL(path)
    lib.odin_decode_wav.restype = ctypes.c_int
    lib.odin_decode_wav.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.odin_pack_batch.restype = ctypes.c_int
    lib.odin_pack_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float32), ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        ctypes.c_int32]
    lib.odin_frame_signal.restype = ctypes.c_int64
    lib.odin_frame_signal.argtypes = [
        np.ctypeslib.ndpointer(np.float32), ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float32), ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float32), ctypes.c_int64]
    lib.odin_gather.restype = ctypes.c_int
    lib.odin_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int32]
    _LIB, _PATH = lib, path
  except Exception:
    _LIB = None
  return _LIB


def native_available() -> bool:
  return load_native() is not None


def library_file() -> Optional[str]:
  """The path of the loaded library, None without one."""
  load_native()
  return _PATH


def decode_wav(path_or_bytes, max_seconds: float = 600.0
               ) -> Tuple[np.ndarray, int]:
  """wav -> (float32 mono samples, sr); native decoder with python
  fallback."""
  lib = load_native()
  data = path_or_bytes
  if isinstance(data, str):
    with open(data, "rb") as f:
      data = f.read()
  if lib is not None:
    cap = int(max_seconds * 48000)
    out = np.empty(cap, np.float32)
    sr = ctypes.c_int32(0)
    n = lib.odin_decode_wav(data, len(data), out, cap, ctypes.byref(sr))
    if n >= 0:
      return out[:n].copy(), int(sr.value)
  from odin_tpu_torch.preprocessing.speech import read_wave
  y, sr = read_wave(path_or_bytes if isinstance(path_or_bytes, str)
                    else data)
  if y.ndim > 1:
    y = y.mean(-1)
  return y.astype(np.float32), sr


def pack_batch(paths: Sequence[str], max_samples: int,
               n_threads: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Decode many wavs into a zero-padded (n, max_samples) float32 block
  (+ lengths, sample rates) — the native ingest path feeding
  `ops.features.speech_features`."""
  lib = load_native()
  n = len(paths)
  out = np.zeros((n, max_samples), np.float32)
  lengths = np.zeros(n, np.int32)
  srs = np.zeros(n, np.int32)
  if lib is not None:
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    n_threads = n_threads or min(os.cpu_count() or 1, 8)
    lib.odin_pack_batch(arr, n, out, max_samples, lengths, srs, n_threads)
    return out, lengths, srs
  for i, p in enumerate(paths):
    try:
      y, sr = decode_wav(p)
      k = min(len(y), max_samples)
      out[i, :k] = y[:k]
      lengths[i] = k
      srs[i] = sr
    except Exception:
      pass
  return out, lengths, srs


def gather(arr: np.ndarray, idx: np.ndarray, out: Optional[np.ndarray] = None,
           n_threads: Optional[int] = None) -> np.ndarray:
  """``arr[idx]`` for a contiguous array via the native threaded gather —
  the batch-assembly hot path of `DataPipeline` (numpy fancy indexing is a
  single-threaded row-copy loop).  Exact same result; falls back to
  ``arr[idx]`` without the native lib.  `out` reuses a preallocated buffer.
  """
  lib = load_native()
  idx = np.ascontiguousarray(idx, np.int64)
  if (lib is None or not isinstance(arr, np.ndarray)
      or not arr.flags["C_CONTIGUOUS"] or arr.ndim < 1
      or arr.dtype.hasobject  # raw memcpy of PyObject* would skip refcounts
      # negative or out-of-range rows: numpy wraps or raises
      or (len(idx) and (idx.min() < 0 or idx.max() >= len(arr)))):
    res = arr[idx]
    if out is not None:
      out[...] = res
      return out
    return res
  item_bytes = int(arr.itemsize * np.prod(arr.shape[1:], dtype=np.int64))
  if out is None:
    out = np.empty((len(idx),) + arr.shape[1:], arr.dtype)
  n_threads = n_threads or min(os.cpu_count() or 1, 8)
  lib.odin_gather(arr.ctypes.data_as(ctypes.c_void_p), item_bytes, idx,
                  len(idx), out.ctypes.data_as(ctypes.c_void_p), n_threads)
  return out


def frame_signal_native(y: np.ndarray, frame_length: int, step_length: int,
                        window: Optional[np.ndarray] = None) -> np.ndarray:
  """Fused framing+window on host (native fast path)."""
  lib = load_native()
  y = np.ascontiguousarray(y, np.float32)
  n_frames = max(0, 1 + (len(y) - frame_length) // step_length)
  out = np.empty((n_frames, frame_length), np.float32)
  if n_frames == 0:
    return out
  if lib is not None:
    w = np.ascontiguousarray(window, np.float32) if window is not None else \
        np.ones(frame_length, np.float32)
    lib.odin_frame_signal(y, len(y), w, frame_length, step_length, out,
                          n_frames)
    return out
  from odin_tpu_torch.preprocessing.signal import segment_axis
  frames = segment_axis(y, frame_length, step_length, end="cut")
  return frames * window if window is not None else frames
