"""ScoreBoard: a results table over sqlite3 shared by experiments (a copy
of ``odin_tpu/training/scores.py``): ``write(table, unique, replace,
**row)`` and ``select``, each table's columns made and widened from the
rows written.  Host only; a file written by either package reads in the
other."""
from __future__ import annotations

import json
import os
import sqlite3
import time
from typing import Any, Dict, List, Optional, Sequence, Union

__all__ = ["ScoreBoard"]


def _col_type(v) -> str:
  if isinstance(v, bool):
    return "INTEGER"
  if isinstance(v, int):
    return "INTEGER"
  if isinstance(v, float):
    return "REAL"
  return "TEXT"


def _encode(v):
  if isinstance(v, (int, float, str, bytes)) or v is None:
    return v
  if isinstance(v, bool):
    return int(v)
  return json.dumps(v)


class ScoreBoard:

  def __init__(self, path: str = "scoreboard.db"):
    self.path = path
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    self._conn = sqlite3.connect(path)
    self._conn.row_factory = sqlite3.Row

  def _safe(self, name: str) -> str:
    return "".join(c for c in str(name) if c.isalnum() or c == "_")

  def _ensure_table(self, table: str, row: Dict[str, Any]):
    table = self._safe(table)
    cols = ", ".join(f"{self._safe(k)} {_col_type(v)}" for k, v in row.items())
    self._conn.execute(f"CREATE TABLE IF NOT EXISTS {table} ({cols})")
    # add any new columns
    existing = {r[1] for r in self._conn.execute(f"PRAGMA table_info({table})")}
    for k, v in row.items():
      if self._safe(k) not in existing:
        self._conn.execute(
            f"ALTER TABLE {table} ADD COLUMN {self._safe(k)} {_col_type(v)}")

  def write(self, table: str, unique: Optional[Sequence[str]] = None,
            replace: bool = True, **row) -> "ScoreBoard":
    """Insert a row (with a ``timestamp`` unless given); with `unique`
    keys, a row matching them is deleted first where `replace`, else the
    new row is dropped."""
    row.setdefault("timestamp", time.time())
    self._ensure_table(table, row)
    table = self._safe(table)
    if isinstance(unique, str):  # a single key, not an iterable of chars
      unique = (unique,)
    if unique:
      cond = " AND ".join(f"{self._safe(k)}=?" for k in unique)
      exists = self._conn.execute(
          f"SELECT COUNT(*) FROM {table} WHERE {cond}",
          [_encode(row[k]) for k in unique]).fetchone()[0]
      if exists:
        if not replace:
          return self
        self._conn.execute(f"DELETE FROM {table} WHERE {cond}",
                           [_encode(row[k]) for k in unique])
    keys = list(row.keys())
    self._conn.execute(
        f"INSERT INTO {table} ({', '.join(self._safe(k) for k in keys)}) "
        f"VALUES ({', '.join('?' * len(keys))})",
        [_encode(row[k]) for k in keys])
    self._conn.commit()
    return self

  def select(self, table: str, where: Optional[Dict[str, Any]] = None,
             order_by: Optional[str] = None) -> List[Dict[str, Any]]:
    """Rows as dicts, those matching `where`, sorted by `order_by`; none
    where the table does not exist."""
    table = self._safe(table)
    q = f"SELECT * FROM {table}"
    params: list = []
    if where:
      q += " WHERE " + " AND ".join(f"{self._safe(k)}=?" for k in where)
      params = [_encode(v) for v in where.values()]
    if order_by:
      q += f" ORDER BY {self._safe(order_by)}"
    try:
      rows = self._conn.execute(q, params).fetchall()
    except sqlite3.OperationalError:
      return []
    return [dict(r) for r in rows]

  def tables(self) -> List[str]:
    return [r[0] for r in self._conn.execute(
        "SELECT name FROM sqlite_master WHERE type='table'")]

  def dataframe(self, table: str):
    import pandas as pd
    return pd.DataFrame(self.select(table))

  def close(self):
    self._conn.commit()
    self._conn.close()
