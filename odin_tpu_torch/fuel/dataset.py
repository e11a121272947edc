"""Folder-of-arrays dataset container (host only): a copy of
``odin_tpu/fuel/dataset.py``.  ``Dataset`` parses a directory into named
items: ``MmapArray`` pairs (raw rows + ``.json`` header), ``MmapDict``
stores (``.idx`` sidecar), ``.npy``/``.npz`` files, pickles and sqlite
databases.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Iterator, Tuple

import numpy as np

from odin_tpu_torch.fuel.databases import MmapArray, MmapDict, SQLiteDict
from odin_tpu_torch.utils import md5_checksum

__all__ = ["Dataset"]


class Dataset:
  """A directory of named arrays/dicts."""

  def __init__(self, path: str, read_only: bool = False):
    self.path = os.path.abspath(path)
    os.makedirs(self.path, exist_ok=True)
    self.read_only = bool(read_only)
    self._items: Dict[str, Any] = {}
    self._scan()

  def _scan(self):
    self._items.clear()
    for fname in sorted(os.listdir(self.path)):
      fpath = os.path.join(self.path, fname)
      name, ext = os.path.splitext(fname)
      if ext == ".json" or fname.endswith(".idx"):
        continue  # sidecars
      if ext == ".npy":
        self._items[name] = ("npy", fpath)
      elif ext == ".npz":
        self._items[name] = ("npz", fpath)
      elif ext in (".pkl", ".pickle"):
        self._items[name] = ("pickle", fpath)
      elif ext == ".db":
        self._items[name] = ("sqlite", fpath)
      elif os.path.exists(fpath + ".json"):
        self._items[name] = ("mmap", fpath)
      elif os.path.exists(fpath + ".idx"):
        self._items[name] = ("mmapdict", fpath)

  def keys(self):
    return self._items.keys()

  def __contains__(self, name: str) -> bool:
    return name in self._items

  def __iter__(self) -> Iterator[str]:
    return iter(self._items)

  def __len__(self) -> int:
    return len(self._items)

  def __getitem__(self, name: str):
    kind, fpath = self._items[name]
    if kind == "npy":
      return np.load(fpath, mmap_mode="r")
    if kind == "npz":
      return dict(np.load(fpath))
    if kind == "pickle":
      with open(fpath, "rb") as f:
        return pickle.load(f)
    if kind == "sqlite":
      return SQLiteDict(fpath)
    if kind == "mmap":
      return MmapArray(fpath)
    if kind == "mmapdict":
      return MmapDict(fpath, read_only=True)
    raise KeyError(name)

  def __setitem__(self, name: str, value):
    if self.read_only:
      raise IOError("Dataset is read-only")
    if isinstance(value, np.ndarray):
      np.save(os.path.join(self.path, name + ".npy"), value)
    elif isinstance(value, dict) and all(
        isinstance(v, np.ndarray) for v in value.values()):
      np.savez(os.path.join(self.path, name + ".npz"), **value)
    else:
      with open(os.path.join(self.path, name + ".pkl"), "wb") as f:
        pickle.dump(value, f)
    self._scan()

  def get_md5_checksum(self, excluded=()) -> str:
    """md5 of all content files."""
    digests = []
    for fname in sorted(os.listdir(self.path)):
      if any(fname.startswith(e) for e in excluded):
        continue
      digests.append(md5_checksum(os.path.join(self.path, fname)))
    return md5_checksum("".join(digests).encode())

  def __repr__(self):
    items = ", ".join(f"{k}:{v[0]}" for k, v in self._items.items())
    return f"Dataset('{self.path}', {{{items}}})"
