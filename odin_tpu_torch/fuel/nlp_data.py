"""The procedural NLP datasets of the port (PyTorch port of
``odin_tpu/fuel/nlp_data.py``: ``NLPDataset`` :22, ``MathArithmetic``
:158-210 and ``SyntheticBoW`` :268-302).

Both are ``np.random.RandomState`` programs: for the same seed they give
the JAX package's arrays exactly.  The text corpora that need files
(20-newsgroups, Tiny Shakespeare, IMDB) are not ported yet.
"""
from __future__ import annotations

import numpy as np

from odin_tpu_torch.fuel.dataset_base import IterableDataset, get_partition

__all__ = ["NLPDataset", "SyntheticBoW", "MathArithmetic"]


def _split(n: int, partition: str) -> slice:
  """80/10/10 train/valid/test slices of n rows."""
  return get_partition(partition, train=slice(0, int(0.8 * n)),
                       valid=slice(int(0.8 * n), int(0.9 * n)),
                       test=slice(int(0.9 * n), n))


class NLPDataset(IterableDataset):

  @property
  def data_type(self):
    return "text"


class MathArithmetic(NLPDataset):
  """Character-level arithmetic problems ``"a op b"`` and their answers,
  tokenised by character (0 pads)."""

  VOCAB = "0123456789+-* ="

  def __init__(self, n_samples: int = 20000, max_operand: int = 99,
               maxlen: int = 12, seed: int = 1):
    super().__init__(seed=seed)
    rng = np.random.RandomState(seed)
    self.maxlen = int(maxlen)
    self.char_to_id = {c: i + 1 for i, c in enumerate(self.VOCAB)}
    probs, answers = [], []
    for _ in range(n_samples):
      a, b = rng.randint(0, max_operand + 1, 2)
      op = rng.choice(["+", "-", "*"])
      c = {"+": a + b, "-": a - b, "*": a * b}[op]
      probs.append(f"{a}{op}{b}")
      answers.append(str(c))
    self._x = self._encode(probs)
    self._y = self._encode(answers)

  def _encode(self, texts):
    out = np.zeros((len(texts), self.maxlen), np.int64)
    for i, t in enumerate(texts):
      ids = [self.char_to_id[ch] for ch in t[:self.maxlen]]
      out[i, :len(ids)] = ids
    return out

  @property
  def name(self):
    return "matharithmetic"

  @property
  def shape(self):
    return (self.maxlen,)

  @property
  def vocab_size(self):
    return len(self.VOCAB) + 1

  def decode(self, ids) -> str:
    inv = {i: c for c, i in self.char_to_id.items()}
    return "".join(inv.get(int(i), "") for i in np.asarray(ids).ravel())

  def _load(self, partition: str):
    sl = _split(len(self._x), partition)
    return self._x[sl], self._y[sl]


class SyntheticBoW(NLPDataset):
  """A bag-of-words corpus drawn from an LDA model with known topics:
  ``topics`` (n_topics, n_words) from Dirichlet(0.05), each document's
  mixture from Dirichlet(0.3), `doc_length` words from the mixed word
  distribution; the label is the document's largest topic."""

  def __init__(self, n_docs: int = 2000, n_words: int = 200,
               n_topics: int = 8, doc_length: int = 80, seed: int = 1):
    super().__init__(seed=seed)
    self.n_words = int(n_words)
    self.n_topics = int(n_topics)
    rng = np.random.RandomState(seed)
    self.topics = rng.dirichlet(np.full(n_words, 0.05), size=n_topics)
    theta = rng.dirichlet(np.full(n_topics, 0.3), size=n_docs)
    word_p = theta @ self.topics
    x = np.stack([rng.multinomial(doc_length, p) for p in word_p])
    self._x = x.astype("float32")
    self._y = theta.argmax(-1).astype("int64")

  @property
  def name(self):
    return "syntheticbow"

  @property
  def shape(self):
    return (self.n_words,)

  @property
  def labels(self):
    return [f"topic{i}" for i in range(self.n_topics)]

  def _load(self, partition: str):
    sl = _split(len(self._x), partition)
    return self._x[sl], self._y[sl]
