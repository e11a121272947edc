"""On-disk key-value stores and appendable memory-mapped arrays (host
only): a copy of ``odin_tpu/fuel/databases.py``.  The files are
byte-compatible with the JAX package's: the pickled ``.idx`` index of
``MmapDict``, the ``.json`` header and raw rows of ``MmapArrayWriter``, and
the sqlite tables of ``SQLiteDict``/``TableDict``, so a store written by
either package opens in the other.
"""
from __future__ import annotations

import json
import os
import pickle
import sqlite3
from collections.abc import MutableMapping
from typing import Any, Iterator, Optional, Tuple

import numpy as np

__all__ = ["MmapDict", "SQLiteDict", "MmapArray", "MmapArrayWriter",
           "TableDict"]


class MmapDict(MutableMapping):
  """On-disk dict with MEMORY-MAPPED reads: values pickled into a data
  file, key -> (offset, length) index saved alongside (reference
  ``databases.py:232``).  Lookups slice an `mmap` of the data file — no
  seek/read syscalls, and hot values ride the page cache across
  processes."""

  def __init__(self, path: str, read_only: bool = False):
    self.path = path
    self.read_only = bool(read_only)
    self._index_path = path + ".idx"
    self._index = {}
    if os.path.exists(self._index_path):
      with open(self._index_path, "rb") as f:
        self._index = pickle.load(f)
    mode = "rb" if read_only else ("r+b" if os.path.exists(path) else "w+b")
    self._file = open(path, mode)
    self._mmap = None
    self._mmap_size = 0

  def _view(self, off: int, length: int) -> memoryview:
    import mmap as _mmap
    end = off + length
    if self._mmap is None or end > self._mmap_size:
      if self._mmap is not None:
        self._mmap.close()
      self._file.flush()
      size = os.fstat(self._file.fileno()).st_size
      self._mmap = _mmap.mmap(self._file.fileno(), size,
                              access=_mmap.ACCESS_READ)
      self._mmap_size = size
    return memoryview(self._mmap)[off:end]

  def __getitem__(self, key):
    off, length = self._index[key]
    return pickle.loads(self._view(off, length))

  def __setitem__(self, key, value):
    if self.read_only:
      raise IOError("MmapDict opened read-only")
    self._file.seek(0, 2)
    off = self._file.tell()
    data = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
    self._file.write(data)
    self._index[key] = (off, len(data))

  def __delitem__(self, key):
    del self._index[key]  # data space is not reclaimed

  def __iter__(self) -> Iterator:
    return iter(self._index)

  def __len__(self) -> int:
    return len(self._index)

  def flush(self):
    if not self.read_only:
      self._file.flush()
      with open(self._index_path, "wb") as f:
        pickle.dump(self._index, f)

  def close(self):
    self.flush()
    if self._mmap is not None:
      self._mmap.close()
      self._mmap = None
    self._file.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


class SQLiteDict(MutableMapping):
  """Dict over a sqlite table (reference ``databases.py:575``)."""

  def __init__(self, path: str, table: str = "data"):
    self.path = path
    self.table = "".join(c for c in table if c.isalnum() or c == "_")
    self._conn = sqlite3.connect(path)
    self._conn.execute(
        f"CREATE TABLE IF NOT EXISTS {self.table} "
        "(key TEXT PRIMARY KEY, value BLOB)")

  def __getitem__(self, key):
    row = self._conn.execute(
        f"SELECT value FROM {self.table} WHERE key=?", (str(key),)).fetchone()
    if row is None:
      raise KeyError(key)
    return pickle.loads(row[0])

  def __setitem__(self, key, value):
    self._conn.execute(
        f"INSERT OR REPLACE INTO {self.table} VALUES (?, ?)",
        (str(key), pickle.dumps(value)))

  def __delitem__(self, key):
    cur = self._conn.execute(
        f"DELETE FROM {self.table} WHERE key=?", (str(key),))
    if cur.rowcount == 0:
      raise KeyError(key)

  def __iter__(self):
    for (k,) in self._conn.execute(f"SELECT key FROM {self.table}"):
      yield k

  def __len__(self):
    return self._conn.execute(f"SELECT COUNT(*) FROM {self.table}").fetchone()[0]

  def flush(self):
    self._conn.commit()

  def close(self):
    self.flush()
    self._conn.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


class MmapArrayWriter:
  """Append rows to a growable on-disk array (raw data + json header)."""

  def __init__(self, path: str, shape: Tuple[int, ...] = None,
               dtype: str = "float32"):
    self.path = path
    self._header_path = path + ".json"
    if os.path.exists(self._header_path):
      with open(self._header_path) as f:
        h = json.load(f)
      self.row_shape = tuple(h["row_shape"])
      self.dtype = np.dtype(h["dtype"])
      self.n_rows = h["n_rows"]
      self._file = open(path, "ab")
    else:
      assert shape is not None, "shape required for a new MmapArray"
      self.row_shape = tuple(shape[1:]) if len(shape) > 1 else ()
      self.dtype = np.dtype(dtype)
      self.n_rows = 0
      self._file = open(path, "wb")

  def write(self, rows: np.ndarray):
    rows = np.ascontiguousarray(rows, self.dtype)
    if tuple(rows.shape[1:]) != self.row_shape:
      raise ValueError(f"row shape {rows.shape[1:]} != {self.row_shape}")
    self._file.write(rows.tobytes())
    self.n_rows += len(rows)

  def flush(self):
    self._file.flush()
    with open(self._header_path, "w") as f:
      json.dump({"row_shape": list(self.row_shape),
                 "dtype": self.dtype.name,
                 "n_rows": self.n_rows}, f)

  def close(self):
    self.flush()
    self._file.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


def MmapArray(path: str) -> np.memmap:
  """Open an array written by `MmapArrayWriter` as a read-only memmap."""
  with open(path + ".json") as f:
    h = json.load(f)
  shape = (h["n_rows"],) + tuple(h["row_shape"])
  return np.memmap(path, dtype=np.dtype(h["dtype"]), mode="r", shape=shape)


class TableDict(MutableMapping):
  """View of ONE table of a `SQLiteDict` database file (reference
  ``databases.py:458``): several named tables share one connection/file."""

  def __init__(self, sqlite: "SQLiteDict", table_name: str):
    if not isinstance(sqlite, SQLiteDict):
      raise ValueError("`sqlite` must be a SQLiteDict")
    self._sqlite = sqlite
    self.table = "".join(c for c in str(table_name)
                         if c.isalnum() or c == "_")
    sqlite._conn.execute(
        f"CREATE TABLE IF NOT EXISTS {self.table} "
        "(key TEXT PRIMARY KEY, value BLOB)")

  @property
  def sqlite(self) -> "SQLiteDict":
    return self._sqlite

  def _execute(self, sql, *args):
    return self._sqlite._conn.execute(sql.format(t=self.table), *args)

  def __getitem__(self, key):
    row = self._execute("SELECT value FROM {t} WHERE key=?",
                        (str(key),)).fetchone()
    if row is None:
      raise KeyError(key)
    return pickle.loads(row[0])

  def __setitem__(self, key, value):
    self._execute("INSERT OR REPLACE INTO {t} (key, value) VALUES (?, ?)",
                  (str(key), pickle.dumps(value)))
    self._sqlite._conn.commit()

  def __delitem__(self, key):
    if str(key) not in self:
      raise KeyError(key)
    self._execute("DELETE FROM {t} WHERE key=?", (str(key),))
    self._sqlite._conn.commit()

  def __contains__(self, key):
    return self._execute("SELECT 1 FROM {t} WHERE key=?",
                         (str(key),)).fetchone() is not None

  def __iter__(self):
    for (k,) in self._execute("SELECT key FROM {t}"):
      yield k

  def __len__(self):
    return self._execute("SELECT COUNT(*) FROM {t}").fetchone()[0]
