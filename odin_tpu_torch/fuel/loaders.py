"""The archive loaders of the port (PyTorch port of
``odin_tpu/fuel/loaders.py``: ``DataLoader`` :32, ``load`` :63, the named
loaders :69-127 and ``load_glove`` :118).

Nothing is downloaded: a loader reads ``<data dir>/<name>.npz`` (a dict
of its arrays) or the extracted folder ``<data dir>/<name>/`` (a
read-only ``fuel.dataset.Dataset``), and raises ``FileNotFoundError``
naming the path otherwise.  IRIS is read from the port's own copy of the
UCI iris table (``iris.csv``, the file scikit-learn ships), as the JAX
package reads it through ``sklearn.datasets.load_iris``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from odin_tpu_torch.fuel.dataset import Dataset
from odin_tpu_torch.utils import get_data_path

__all__ = ["DataLoader", "load", "load_iris", "load_glove",
           "MNIST_original", "FMNIST_original", "MNIST_dropout",
           "FMNIST_dropout", "TIDIGITS", "SPEECH_SAMPLES", "IRIS",
           "CMUarctic", "MUSAN", "openSMILEsad"]

_KNOWN = {
    "mnist_original": "MNIST raw arrays",
    "tidigits": "TIDIGITS spoken-digit corpus",
    "musan": "MUSAN music/speech/noise corpus",
    "cmuarctic": "CMU Arctic speech corpus",
    "iris": "UCI iris (available offline via sklearn)",
    "opensmilesad": "openSMILE SAD model files",
}


def load_iris():
  """(150 x 4 float32 measurements, int64 species 0-2) of the UCI iris
  table."""
  path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "iris.csv")
  table = np.loadtxt(path, delimiter=",", skiprows=1)
  return table[:, :4].astype("float32"), table[:, 4].astype("int64")


class DataLoader:
  """A corpus by name, from the data directory (or `path`)."""

  def __init__(self, name: str, path: Optional[str] = None):
    self.name = str(name).lower()
    self.path = path or os.path.join(get_data_path(), self.name)

  @property
  def is_available(self) -> bool:
    return os.path.exists(self.path) or \
        os.path.exists(self.path + ".npz") or self.name == "iris"

  def load(self):
    if self.name == "iris":
      return load_iris()
    if os.path.exists(self.path + ".npz"):
      return dict(np.load(self.path + ".npz"))
    if os.path.isdir(self.path):
      return Dataset(self.path, read_only=True)
    known = f" ({_KNOWN[self.name]})" if self.name in _KNOWN else ""
    raise FileNotFoundError(
        f"corpus '{self.name}'{known} not found at {self.path}; this "
        "environment has no network egress — place the extracted archive "
        "or an .npz there")


def load(name: str, path: Optional[str] = None):
  return DataLoader(name, path).load()


def _named(cls_name: str, corpus: str):
  def __init__(self, path: Optional[str] = None):
    DataLoader.__init__(self, corpus, path)
  return type(cls_name, (DataLoader,), {
      "__init__": __init__, "__doc__": f"The '{corpus}' corpus."})


MNIST_original = _named("MNIST_original", "mnist_original")
TIDIGITS = _named("TIDIGITS", "tidigits")
FMNIST_original = _named("FMNIST_original", "fmnist_original")
MNIST_dropout = _named("MNIST_dropout", "mnist_dropout")
FMNIST_dropout = _named("FMNIST_dropout", "fmnist_dropout")
SPEECH_SAMPLES = _named("SPEECH_SAMPLES", "speech_samples")
IRIS = _named("IRIS", "iris")
CMUarctic = _named("CMUarctic", "cmuarctic")
MUSAN = _named("MUSAN", "musan")
openSMILEsad = _named("openSMILEsad", "opensmilesad")


def load_glove(ndim: int = 100, path: Optional[str] = None):
  """GloVe word vectors as {word: (ndim,) float32}, from
  ``glove.6B.<ndim>d.txt`` in the data directory (or `path`)."""
  path = path or os.path.join(get_data_path(), f"glove.6B.{ndim}d.txt")
  if not os.path.exists(path):
    raise FileNotFoundError(
        f"GloVe file not found at {path}; no network egress — download "
        "glove.6B and place the .txt there")
  emb = {}
  with open(path, "r", encoding="utf-8") as f:
    for line in f:
      parts = line.rstrip().split(" ")
      emb[parts[0]] = np.asarray(parts[1:], dtype="float32")
  return emb
