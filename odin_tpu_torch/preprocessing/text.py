"""Text tokenization of the port (a copy of
``odin_tpu/preprocessing/text.py``, host Python): the tokenizer with
vocabulary building, frequency filtering, padding, n-grams and the
count/binary/TF-IDF matrices, the stop words, and the text preprocessors
and token filters.  The English stop words are scikit-learn's list, the one
``fuel.nlp_data``'s TF-IDF uses (``fuel._stop_words``), so no
scikit-learn is imported.
"""
from __future__ import annotations

import re
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

__all__ = ["simple_tokenizer", "Tokenizer", "ngrams"]

_WORD_RE = re.compile(r"[A-Za-z']+|[0-9]+|[^\sA-Za-z0-9]")


def simple_tokenizer(text: str, lower: bool = True,
                     keep_punct: bool = False) -> List[str]:
  if lower:
    text = text.lower()
  tokens = _WORD_RE.findall(text)
  if not keep_punct:
    tokens = [t for t in tokens if any(c.isalnum() for c in t)]
  return tokens


def ngrams(tokens: Sequence[str], n: int = 2) -> List[str]:
  return ["_".join(tokens[i:i + n]) for i in range(len(tokens) - n + 1)]


class Tokenizer:
  """Vocabulary-building tokenizer with encode/decode/pad and matrix modes.

  Special ids: 0 = <pad>, 1 = <unk>.
  """

  def __init__(self, n_words: Optional[int] = None, min_freq: int = 1,
               lower: bool = True, char_level: bool = False):
    self.n_words = n_words
    self.min_freq = int(min_freq)
    self.lower = bool(lower)
    self.char_level = bool(char_level)
    self.word_index: Dict[str, int] = {}
    self.index_word: Dict[int, str] = {}
    self.counts: Counter = Counter()

  def _tokenize(self, text: str) -> List[str]:
    if self.char_level:
      return list(text.lower() if self.lower else text)
    return simple_tokenizer(text, lower=self.lower)

  def fit(self, texts: Iterable[str]) -> "Tokenizer":
    for t in texts:
      self.counts.update(self._tokenize(t))
    vocab = [w for w, c in self.counts.most_common()
             if c >= self.min_freq]
    if self.n_words is not None:
      vocab = vocab[:self.n_words - 2]
    self.word_index = {w: i + 2 for i, w in enumerate(vocab)}
    self.word_index["<pad>"] = 0
    self.word_index["<unk>"] = 1
    self.index_word = {i: w for w, i in self.word_index.items()}
    return self

  @property
  def vocab_size(self) -> int:
    return len(self.word_index)

  def encode(self, text: str) -> List[int]:
    return [self.word_index.get(w, 1) for w in self._tokenize(text)]

  def decode(self, ids: Sequence[int]) -> str:
    sep = "" if self.char_level else " "
    return sep.join(self.index_word.get(int(i), "<unk>") for i in ids
                    if int(i) != 0)

  def transform(self, texts: Sequence[str], maxlen: Optional[int] = None,
                mode: str = "seq") -> np.ndarray:
    """mode: 'seq' (padded id sequences), 'count' (BoW counts), 'tfidf',
    'binary'."""
    if mode == "seq":
      seqs = [self.encode(t) for t in texts]
      maxlen = maxlen or max((len(s) for s in seqs), default=1)
      out = np.zeros((len(seqs), maxlen), np.int64)
      for i, s in enumerate(seqs):
        s = s[:maxlen]
        out[i, :len(s)] = s
      return out
    V = self.vocab_size
    mat = np.zeros((len(texts), V), np.float32)
    for i, t in enumerate(texts):
      for idx in self.encode(t):
        mat[i, idx] += 1.0
    if mode == "count":
      return mat
    if mode == "binary":
      return (mat > 0).astype(np.float32)
    if mode == "tfidf":
      df = (mat > 0).sum(0)
      idf = np.log((1.0 + len(texts)) / (1.0 + df)) + 1.0
      tf = mat / np.maximum(mat.sum(1, keepdims=True), 1.0)
      return tf * idf[None, :]
    raise ValueError(f"unknown mode '{mode}'")

  fit_transform = lambda self, texts, **kw: self.fit(texts).transform(texts, **kw)


# ---------------------------------------------------------------------------
# preprocessors + token filters (reference ``text.py:33-258``)
# ---------------------------------------------------------------------------
_EXTRA_STOPWORDS: set = set()


def add_stopword(words) -> None:
  """Extend the stopword list (reference ``text.py:46``)."""
  if isinstance(words, str):
    words = (words,)
  _EXTRA_STOPWORDS.update(str(w).lower() for w in words)


def _builtin_stopwords() -> frozenset:
  from odin_tpu_torch.fuel._stop_words import ENGLISH_STOP_WORDS
  return ENGLISH_STOP_WORDS


def is_stopword(word: str, lang: str = "en") -> bool:
  """Stopword test (reference ``text.py:52``; scikit-learn's English list
  replaces the spaCy vocabulary, no model download)."""
  if lang != "en":
    raise ValueError("only English stopwords are bundled offline")
  w = str(word).lower()
  return w in _EXTRA_STOPWORDS or w in _builtin_stopwords()


def is_oov(word: str, vocab) -> bool:
  """Out-of-vocabulary test against an explicit vocabulary (reference
  ``text.py:64`` used the spaCy string store; here the caller provides the
  vocab — e.g. ``tokenizer.word_index``)."""
  return str(word) not in vocab


class TextPreprocessor:
  """String -> string/tokens stage (reference ``text.py:76``)."""

  def preprocess(self, text):
    raise NotImplementedError

  def __call__(self, text):
    if isinstance(text, (tuple, list)):
      return [self.preprocess(t) for t in text]
    return self.preprocess(text)


class CasePreprocessor(TextPreprocessor):
  """Lower-case + split, optionally preserving ALL-CAPS names (reference
  ``text.py:92``)."""

  def __init__(self, lower: bool = True, keep_name: bool = True,
               split: Optional[str] = " "):
    self.lower = bool(lower)
    self.keep_name = bool(keep_name)
    self.split = split

  def preprocess(self, text):
    if self.split is not None:
      tokens = [t for t in text.split(self.split) if t]
      if self.lower:
        tokens = [t if self.keep_name and t.isupper() else t.lower()
                  for t in tokens]
      return tokens
    return text.lower() if self.lower else text


class TransPreprocessor(TextPreprocessor):
  """Translate a character set to replacements (reference ``text.py:113``;
  the py2 ``string.maketrans``/``unicode`` body is replaced by
  ``str.translate``)."""

  def __init__(self, old: str = "!\"#$%&()*+,-./:;<=>?@[\\]^_`{|}~\t\n",
               new: str = " "):
    self._table = str.maketrans({c: new for c in old})

  def preprocess(self, text):
    if isinstance(text, (tuple, list)):
      text = " ".join(text)
    return text.translate(self._table).strip()


class TokenFilter:
  """Token -> token-or-'' stage; '' drops the token (reference
  ``text.py:139``)."""

  def filter(self, token: str, pos: Optional[str] = None) -> str:
    raise NotImplementedError

  def __call__(self, token: str, pos: Optional[str] = None) -> str:
    return self.filter(token, pos)


class TYPEfilter(TokenFilter):
  """Accept tokens by character type (reference ``text.py:154``): any
  enabled predicate accepts the token."""

  def __init__(self, is_alpha: bool = False, is_digit: bool = False,
               is_ascii: bool = False, is_title: bool = False):
    self.predicates = []
    if is_alpha:
      self.predicates.append(str.isalpha)
    if is_digit:
      self.predicates.append(str.isdigit)
    if is_ascii:
      self.predicates.append(str.isascii)
    if is_title:
      self.predicates.append(str.istitle)

  def filter(self, token, pos=None):
    return token if any(p(token) for p in self.predicates) else ""


class POSfilter(TokenFilter):
  """Accept tokens whose part-of-speech tag is in the allowed set
  (reference ``text.py:191``).  Tags are supplied by the caller (e.g. from
  nltk/spaCy when installed) — the filter itself carries no model."""

  def __init__(self, pos: Sequence[str] = ("NOUN", "PROPN", "VERB", "ADJ")):
    self.pos = {str(p).upper() for p in pos}

  def filter(self, token, pos=None):
    if pos is None:
      return token  # no tag information: pass through
    return token if str(pos).upper() in self.pos else ""


__all__ += ["add_stopword", "is_stopword", "is_oov", "TextPreprocessor",
            "CasePreprocessor", "TransPreprocessor", "TokenFilter",
            "TYPEfilter", "POSfilter"]
