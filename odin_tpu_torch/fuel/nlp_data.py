"""The NLP datasets of the port (PyTorch port of
``odin_tpu/fuel/nlp_data.py``: ``NLPDataset`` :22, ``Newsgroup20`` :29,
``Newsgroup5`` :78, ``Newsgroup20_clean`` :97, ``MathArithmetic`` :158,
the character-level ``TinyShakespear`` and ``ImdbReview`` :213-266 and
``SyntheticBoW`` :268).

``MathArithmetic`` and ``SyntheticBoW`` are ``np.random.RandomState``
programs: for the same seed they give the JAX package's arrays exactly.
The others read files that the repository does not hold, from the data
directory (``utils.get_data_path()``) or, for 20-newsgroups, from
scikit-learn's local cache, which is the one place the port imports
scikit-learn (lazily, inside ``Newsgroup20._fetch``); without it they
raise ``FileNotFoundError`` as the JAX package does.  The TF-IDF is the
port's own ``TfidfVectorizer``, which copies scikit-learn's defaults.
"""
from __future__ import annotations

import os
import re
from collections import Counter
from typing import Optional, Sequence

import numpy as np

from odin_tpu_torch.fuel._stop_words import ENGLISH_STOP_WORDS
from odin_tpu_torch.fuel.dataset_base import IterableDataset, get_partition
from odin_tpu_torch.utils import get_data_path

__all__ = ["NLPDataset", "Newsgroup20", "Newsgroup5", "Newsgroup20_clean",
           "SyntheticBoW", "MathArithmetic", "TinyShakespear", "ImdbReview",
           "TfidfVectorizer", "ENGLISH_STOP_WORDS"]


def _split(n: int, partition: str) -> slice:
  """80/10/10 train/valid/test slices of n rows."""
  return get_partition(partition, train=slice(0, int(0.8 * n)),
                       valid=slice(int(0.8 * n), int(0.9 * n)),
                       test=slice(int(0.9 * n), n))


class NLPDataset(IterableDataset):

  @property
  def data_type(self):
    return "text"


class TfidfVectorizer:
  """scikit-learn's ``TfidfVectorizer(max_features=..., stop_words=...)``
  at its other defaults, in numpy: lowercased text, tokens of the pattern
  ``(?u)\\b\\w\\w+\\b`` outside the stop words, the vocabulary in
  alphabetical order cut to the `max_features` most frequent terms over
  the corpus (ties broken as scikit-learn's ``argsort`` breaks them),
  smooth idf ``log((1 + n) / (1 + df)) + 1`` and rows scaled to unit l2
  norm.  ``fit_transform``/``transform`` give dense float64 arrays."""

  def __init__(self, max_features: Optional[int] = None,
               stop_words="english", lowercase: bool = True,
               token_pattern: str = r"(?u)\b\w\w+\b"):
    self.max_features = max_features
    self.stop_words = (ENGLISH_STOP_WORDS if stop_words == "english"
                       else frozenset(stop_words or ()))
    self.lowercase = bool(lowercase)
    self._token = re.compile(token_pattern)

  def _tokens(self, doc: str):
    if self.lowercase:
      doc = doc.lower()
    return [w for w in self._token.findall(doc) if w not in self.stop_words]

  def _counts(self, docs: Sequence[str], vocabulary: dict) -> np.ndarray:
    x = np.zeros((len(docs), len(vocabulary)), np.int64)
    for i, doc in enumerate(docs):
      for w, c in Counter(self._tokens(doc)).items():
        j = vocabulary.get(w)
        if j is not None:
          x[i, j] = c
    return x

  def fit_transform(self, docs: Sequence[str]) -> np.ndarray:
    tokens = [Counter(self._tokens(d)) for d in docs]
    terms = sorted(set().union(*tokens)) if tokens else []
    if not terms:
      raise ValueError("empty vocabulary; perhaps the documents only "
                       "contain stop words")
    index = {w: j for j, w in enumerate(terms)}
    x = np.zeros((len(docs), len(terms)), np.int64)
    for i, counter in enumerate(tokens):
      for w, c in counter.items():
        x[i, index[w]] = c
    if self.max_features is not None and len(terms) > self.max_features:
      # scikit-learn sums float64 counts: the same array argsorts alike
      tfs = x.sum(axis=0).astype(np.float64)
      keep = np.zeros(len(terms), bool)
      keep[(-tfs).argsort()[:self.max_features]] = True
      terms = [w for w, k in zip(terms, keep) if k]
      x = x[:, keep]
    self.vocabulary_ = {w: j for j, w in enumerate(terms)}
    df = (x > 0).sum(axis=0).astype(np.float64) + 1.0
    self.idf_ = np.log((len(docs) + 1) / df) + 1.0
    return self._tfidf(x)

  def transform(self, docs: Sequence[str]) -> np.ndarray:
    return self._tfidf(self._counts(docs, self.vocabulary_))

  def get_feature_names_out(self) -> np.ndarray:
    return np.asarray(sorted(self.vocabulary_, key=self.vocabulary_.get),
                      dtype=object)

  def _tfidf(self, counts: np.ndarray) -> np.ndarray:
    x = counts.astype(np.float64) * self.idf_
    norms = np.sqrt(np.einsum("ij,ij->i", x, x))
    norms[norms == 0.0] = 1.0
    return x / norms[:, None]


class Newsgroup20(NLPDataset):
  """20-newsgroups as TF-IDF vectors of the `n_words` most frequent terms,
  read from scikit-learn's local cache (``fetch_20newsgroups(...,
  download_if_missing=False)``); the train split's last 10 % is the valid
  partition."""

  def __init__(self, n_words: int = 1000, seed: int = 1):
    super().__init__(seed=seed)
    self.n_words = int(n_words)
    self._cache = None

  @property
  def name(self):
    return "newsgroup20"

  @property
  def shape(self):
    return (self.n_words,)

  @property
  def labels(self):
    return [str(i) for i in range(20)]

  def _fetch(self):
    if self._cache is None:
      try:
        from sklearn.datasets import fetch_20newsgroups
        train = fetch_20newsgroups(subset="train", download_if_missing=False)
        test = fetch_20newsgroups(subset="test", download_if_missing=False)
      except Exception as e:
        raise FileNotFoundError(
            "20newsgroups is not cached locally and this environment has no "
            "network egress; use SyntheticBoW for testing") from e
      vec = TfidfVectorizer(max_features=self.n_words, stop_words="english")
      x_train = vec.fit_transform(train.data).astype("float32")
      x_test = vec.transform(test.data).astype("float32")
      self._cache = (x_train, np.asarray(train.target),
                     x_test, np.asarray(test.target))
    return self._cache

  def _load(self, partition: str):
    x_train, y_train, x_test, y_test = self._fetch()
    k = int(0.9 * len(x_train))
    return get_partition(partition,
                         train=(x_train[:k], y_train[:k]),
                         valid=(x_train[k:], y_train[k:]),
                         test=(x_test, y_test))


class Newsgroup5(Newsgroup20):
  """20-newsgroups' labels merged into 5 superclasses."""

  _GROUPS = {0: [0, 15, 19], 1: [1, 2, 3, 4, 5], 2: [6, 7, 8, 9, 10],
             3: [11, 12, 13, 14], 4: [16, 17, 18]}

  @property
  def name(self):
    return "newsgroup5"

  @property
  def labels(self):
    return ["misc", "comp", "rec", "sci", "politics"]

  def _load(self, partition: str):
    x, y = super()._load(partition)
    remap = np.zeros(20, "int64")
    for k, idxs in self._GROUPS.items():
      remap[idxs] = k
    return x, remap[y]


class Newsgroup20_clean(NLPDataset):
  """The pre-cleaned 20-newsgroups word counts for topic models, from
  ``newsgroup20_clean.npz`` (``x_train``, ``x_test``, ``vocab``) in the
  data directory; unlabelled, the train split's documents permuted by
  ``RandomState(1)`` with the first 10 % the valid partition."""

  def __init__(self, path: Optional[str] = None, seed: int = 1):
    super().__init__(seed=seed)
    self.path = path or os.path.join(get_data_path(),
                                     "newsgroup20_clean.npz")
    self._cache = None

  @property
  def name(self):
    return "newsgroup20clean"

  def _fetch(self):
    if self._cache is None:
      if not os.path.exists(self.path):
        raise FileNotFoundError(
            f"newsgroup20_clean not found at {self.path}; no network "
            "egress — place an .npz with x_train/x_test/vocab there, or "
            "use SyntheticBoW for testing")
      self._cache = dict(np.load(self.path, allow_pickle=False))
    return self._cache

  @property
  def vocabulary(self):
    return {i: str(w) for i, w in enumerate(self._fetch()["vocab"])}

  @property
  def vocabulary_size(self) -> int:
    return len(self._fetch()["vocab"])

  @property
  def shape(self):
    return (self._fetch()["x_train"].shape[1],)

  @property
  def labels(self):
    return []

  def _load(self, partition: str):
    arr = self._fetch()
    x_train, x_test = arr["x_train"], arr["x_test"]
    ids = np.random.RandomState(seed=1).permutation(x_train.shape[0])
    start = int(0.1 * x_train.shape[0])
    return get_partition(partition,
                         train=(x_train[ids[start:]], None),
                         valid=(x_train[ids[:start]], None),
                         test=(x_test, None))


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


class _LocalTextDataset(NLPDataset):
  """A character-level corpus from a local text file: the sorted set of
  its characters is the vocabulary, the ids cut into rows of `seq_len`
  (the tail dropped), 90/5/5 train/valid/test."""

  _name = ""
  _filename = ""

  def __init__(self, path: Optional[str] = None, seq_len: int = 128,
               seed: int = 1):
    super().__init__(seed=seed)
    self.seq_len = int(seq_len)
    self.path = path or os.path.join(get_data_path(), self._filename)
    self._cache = None

  @property
  def name(self):
    return self._name

  @property
  def shape(self):
    return (self.seq_len,)

  def _load(self, partition: str):
    if not os.path.exists(self.path):
      raise FileNotFoundError(
          f"'{self._name}' text not found at {self.path} (no network "
          "egress); use MathArithmetic or SyntheticBoW for testing")
    if self._cache is None:
      with open(self.path, encoding="utf-8", errors="replace") as f:
        text = f.read()
      self.char_to_id = {c: i for i, c in enumerate(sorted(set(text)))}
      ids = np.asarray([self.char_to_id[c] for c in text], np.int64)
      n_seq = len(ids) // self.seq_len
      self._cache = ids[:n_seq * self.seq_len].reshape(n_seq, self.seq_len)
    x = self._cache
    n = len(x)
    sl = get_partition(partition, train=slice(0, int(0.9 * n)),
                       valid=slice(int(0.9 * n), int(0.95 * n)),
                       test=slice(int(0.95 * n), n))
    return x[sl], None


class TinyShakespear(_LocalTextDataset):
  """``tinyshakespeare.txt`` in the data directory."""
  _name = "tinyshakespear"
  _filename = "tinyshakespeare.txt"


class ImdbReview(_LocalTextDataset):
  """``imdb.txt`` in the data directory."""
  _name = "imdbreview"
  _filename = "imdb.txt"
