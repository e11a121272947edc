"""The port's on-disk stores (``odin_tpu_torch.fuel.databases``) against the
JAX package's: both packages write the same rows, made with numpy from a
seed, and the files must be byte-equal; a store reopened appends to what is
there, and a store written by one package opens in the other.  No
tolerance: every comparison is exact."""
import os
import sqlite3

import numpy as np
import pytest

from odin_tpu.fuel import databases as jdb
from odin_tpu_torch.fuel import databases as tdb

ROWS = np.random.RandomState(0).randn(37, 5).astype(np.float32)


def _bytes(path):
  with open(path, "rb") as f:
    return f.read()


def _write_mmap_array(mod, path, chunks, dtype="float32"):
  with mod.MmapArrayWriter(path, shape=(0,) + ROWS.shape[1:],
                           dtype=dtype) as w:
    for c in chunks:
      w.write(c)
  return path


@pytest.mark.parametrize("dtype", ["float32", "float16", "uint8"])
def test_mmap_array_files_are_byte_equal(tmp_path, dtype):
  rows = ROWS.astype(dtype) if dtype != "uint8" else \
      (np.abs(ROWS) * 40).astype(np.uint8)
  chunks = [rows[:10], rows[10:11], rows[11:]]
  a = _write_mmap_array(tdb, str(tmp_path / "port"), chunks, dtype)
  b = _write_mmap_array(jdb, str(tmp_path / "jax"), chunks, dtype)
  assert _bytes(a) == _bytes(b)
  assert _bytes(a + ".json") == _bytes(b + ".json")
  np.testing.assert_array_equal(np.asarray(tdb.MmapArray(b)), rows)
  np.testing.assert_array_equal(np.asarray(jdb.MmapArray(a)), rows)


def test_mmap_array_reopens_and_appends(tmp_path):
  path = _write_mmap_array(tdb, str(tmp_path / "a"), [ROWS[:20]])
  with tdb.MmapArrayWriter(path) as w:
    assert w.n_rows == 20 and w.row_shape == (5,)
    w.write(ROWS[20:])
    with pytest.raises(ValueError, match="row shape"):
      w.write(np.zeros((2, 4), np.float32))
  np.testing.assert_array_equal(np.asarray(tdb.MmapArray(path)), ROWS)
  # the JAX package appends to the port's array, and the port reads it
  with jdb.MmapArrayWriter(path) as w:
    w.write(ROWS[:3])
  np.testing.assert_array_equal(np.asarray(tdb.MmapArray(path)),
                                np.concatenate([ROWS, ROWS[:3]]))


def _mmap_dict_items():
  rs = np.random.RandomState(1)
  return [(f"utt{i}.wav", (int(rs.randint(1000)), int(rs.randint(1000))))
          for i in range(12)] + [("array", ROWS[:2]), ("text", "abc")]


def test_mmap_dict_files_are_byte_equal(tmp_path):
  for mod, name in ((tdb, "port"), (jdb, "jax")):
    with mod.MmapDict(str(tmp_path / name)) as d:
      for k, v in _mmap_dict_items():
        d[k] = v
  a, b = str(tmp_path / "port"), str(tmp_path / "jax")
  assert _bytes(a) == _bytes(b)
  assert _bytes(a + ".idx") == _bytes(b + ".idx")
  for mod, path in ((jdb, a), (tdb, b)):
    d = mod.MmapDict(path, read_only=True)
    assert list(d) == [k for k, _ in _mmap_dict_items()]
    assert d["utt3.wav"] == dict(_mmap_dict_items())["utt3.wav"]
    np.testing.assert_array_equal(d["array"], ROWS[:2])
    with pytest.raises(IOError):
      d["x"] = 1
    d.close()


def test_mmap_dict_reopens_and_appends(tmp_path):
  path = str(tmp_path / "d")
  with tdb.MmapDict(path) as d:
    d["a"] = (0, 5)
  with tdb.MmapDict(path) as d:
    assert d["a"] == (0, 5)
    d["b"] = (5, 9)
    assert d["b"] == (5, 9)  # read back before the index is flushed
    del d["a"]
  with jdb.MmapDict(path) as d:
    assert dict(d.items()) == {"b": (5, 9)}
    d["c"] = (9, 10)
  with tdb.MmapDict(path, read_only=True) as d:
    assert dict(d.items()) == {"b": (5, 9), "c": (9, 10)}


def _sqlite_rows(path, table):
  con = sqlite3.connect(path)
  rows = con.execute(f"SELECT key, value FROM {table} ORDER BY key").fetchall()
  schema = con.execute("SELECT sql FROM sqlite_master").fetchall()
  con.close()
  return rows, schema


def test_sqlite_and_table_dicts_store_the_same_rows(tmp_path):
  for mod, name in ((tdb, "port.db"), (jdb, "jax.db")):
    with mod.SQLiteDict(str(tmp_path / name), table="da-ta") as d:
      for k, v in _mmap_dict_items():
        d[k] = v
      t = mod.TableDict(d, "extra table")
      t["k1"] = [1, 2]
      t["k2"] = {"x": 3}
      del t["k1"]
  a, b = str(tmp_path / "port.db"), str(tmp_path / "jax.db")
  for table in ("data", "extratable"):
    assert _sqlite_rows(a, table) == _sqlite_rows(b, table)
  d = jdb.SQLiteDict(a, table="data")
  assert len(d) == len(_mmap_dict_items())
  assert d["utt0.wav"] == dict(_mmap_dict_items())["utt0.wav"]
  t = tdb.TableDict(tdb.SQLiteDict(b, table="data"), "extratable")
  assert dict(t.items()) == {"k2": {"x": 3}} and "k1" not in t
  with pytest.raises(KeyError):
    del t["k1"]
  with pytest.raises(ValueError):
    tdb.TableDict({}, "t")
  d.close()


def test_sqlite_dict_reopens_and_appends(tmp_path):
  path = str(tmp_path / "s.db")
  with tdb.SQLiteDict(path) as d:
    d["a"] = 1
  with tdb.SQLiteDict(path) as d:
    d["b"] = 2
    d["a"] = 3
  with jdb.SQLiteDict(path) as d:
    assert dict(d.items()) == {"a": 3, "b": 2}
    del d["b"]
  with tdb.SQLiteDict(path) as d:
    assert dict(d.items()) == {"a": 3}
    with pytest.raises(KeyError):
      del d["b"]


def test_dataset_reads_each_item_kind(tmp_path):
  """The port's Dataset scans the JAX package's sidecar rules: MmapArray
  (``.json``), MmapDict (``.idx``), ``.npy``, ``.npz``, pickles and sqlite,
  and both packages see the same items and checksum."""
  from odin_tpu.fuel.dataset import Dataset as JaxDataset
  from odin_tpu_torch.fuel.dataset import Dataset
  root = str(tmp_path / "ds")
  ds = Dataset(root)
  ds["arr"] = ROWS
  ds["pair"] = {"a": ROWS[:2], "b": ROWS[2:4]}
  ds["obj"] = {"meta": 1}
  _write_mmap_array(tdb, os.path.join(root, "feat"), [ROWS])
  with tdb.MmapDict(os.path.join(root, "indices_feat")) as d:
    d["u"] = (0, 37)
  with tdb.SQLiteDict(os.path.join(root, "kv.db")) as d:
    d["x"] = 1
  ds._scan()
  jds = JaxDataset(root)
  assert sorted(ds.keys()) == sorted(jds.keys()) == \
      ["arr", "feat", "indices_feat", "kv", "obj", "pair"]
  assert {k: v[0] for k, v in ds._items.items()} == \
      {k: v[0] for k, v in jds._items.items()}
  np.testing.assert_array_equal(ds["feat"], ROWS)
  np.testing.assert_array_equal(ds["arr"], ROWS)
  np.testing.assert_array_equal(ds["pair"]["b"], ROWS[2:4])
  assert ds["obj"] == {"meta": 1} and ds["indices_feat"]["u"] == (0, 37)
  assert ds["kv"]["x"] == 1
  assert ds.get_md5_checksum() == jds.get_md5_checksum()
  assert ds.get_md5_checksum(excluded=("kv",)) == \
      jds.get_md5_checksum(excluded=("kv",))
  ro = Dataset(root, read_only=True)
  with pytest.raises(IOError):
    ro["y"] = ROWS
